"""The port's model code vs the JAX package on the CPU, on the same weights
(the JAX parameters carried across by ``repro_torch.convert``) and the same
numpy-made tokens, pools and block tables.

The JAX side runs ``impl="xla"`` and ``impl="pallas"``; the Pallas kernels
run in interpret mode (the JAX model calls them without ``interpret``, so
the test wraps the kernel entry points it imports at call time). The port
runs ``impl="kernel"`` (whose wrappers take their plain versions for CPU
tensors) and ``impl="plain"``.

Tolerance: float32 throughout, where the two packages differ only in
summation order (XLA's einsums vs PyTorch's matmuls, online vs one-pass
softmax); compounded over the layers and the LM head that stays below
1e-4 of the logits' scale.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention.ops as jax_dec_ops
import repro.kernels.flash_attention.ops as jax_flash_ops
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import layers as JL
from repro.models import rwkv6 as JR
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, MoEConfig

TOL = 1e-4
Bs = 8
ARCHS = ("qwen2.5-3b", "rwkv6-1.6b")


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX model's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(jax_flash_ops, "flash_attention", functools.partial(
        jax_flash_ops.flash_attention, interpret=True))
    monkeypatch.setattr(
        jax_dec_ops, "decode_attention_paged", functools.partial(
            jax_dec_ops.decode_attention_paged, interpret=True))


def _configs(full: bool):
    """(JAX config, port config), float32. ``full``: qwen2.5-3b's head
    geometry (16 q / 2 kv heads, dh 128, d_model 2048) at 2 layers with a
    narrow FFN and vocabulary."""
    if full:
        cut = dict(num_layers=2, d_ff=256, vocab_size=512, dtype="float32")
        return (jax_get_config("qwen2.5-3b").replace(**cut),
                get_config("qwen2.5-3b").replace(**cut))
    return (jax_get_smoke("qwen2.5-3b").replace(dtype="float32"),
            get_smoke_config("qwen2.5-3b").replace(dtype="float32"))


@functools.lru_cache(maxsize=None)
def _params(full: bool):
    jcfg, _ = _configs(full)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _close(got, want, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max abs err {err} (scale {scale})"


# ---------------------------------------------------------------------------
# Config, layers, init


@pytest.mark.parametrize("full", [False, True])
def test_config_mirror_matches_reference(full):
    for arch in ARCHS:
        jcfg = (jax_get_config if full else jax_get_smoke)(arch)
        cfg = (get_config if full else get_smoke_config)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        for prop in ("dh", "q_group", "padded_heads", "padded_kv_heads",
                     "padded_vocab", "can_group_decode", "is_attention_free",
                     "sub_quadratic"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), (arch, prop)
        for fn in ("param_count", "active_param_count",
                   "kv_bytes_per_token"):
            assert getattr(cfg, fn)() == getattr(jcfg, fn)(), (arch, fn)
        assert cfg.tdtype == torch.bfloat16
    if full:        # the figures the port's docs quote
        qwen, rwkv = get_config("qwen2.5-3b"), get_config("rwkv6-1.6b")
        assert qwen.kv_bytes_per_token() == 36_864
        assert round(qwen.param_count() / 1e9, 2) == 3.40
        assert (rwkv.num_layers, rwkv.d_model, rwkv.num_heads, rwkv.dh,
                rwkv.d_ff, rwkv.vocab_size) == (24, 2048, 32, 64, 7168, 65536)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), "rms_norm")
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), "rope")
    h = rng.standard_normal((1, 3, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32)
              for _ in range(2))
    wo = rng.standard_normal((24, 16)).astype(np.float32)
    _close(L.swiglu(*map(torch.from_numpy, (h, wg, wu, wo))),
           JL.swiglu(*map(jnp.asarray, (h, wg, wu, wo))), "swiglu")
    hmap = np.array([0, 0, 1, 1], np.int32)
    kv = x[:, :, :2]
    _close(L.expand_kv(torch.from_numpy(kv), torch.from_numpy(hmap).long()),
           JL.expand_kv(jnp.asarray(kv), jnp.asarray(hmap)), "expand_kv")


def test_init_params_layout_and_scales():
    """Same leaves, shapes and distributions as the reference's init."""
    jcfg, cfg = _configs(False)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.init_params(cfg, 0, device="cpu")
    assert set(p) == set(jp)
    assert len(p["blocks"]) == cfg.num_layers
    for name, leaf in jp["blocks"].items():
        assert tuple(p["blocks"][0][name].shape) == leaf.shape[1:], name
    n = sum(t.numel() for k, t in p.items() if k != "blocks") + sum(
        t.numel() for b in p["blocks"] for t in b.values())
    assert n == cfg.param_count()
    wide = cfg.replace(d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                       num_layers=4, vocab_size=1024)
    p = T.init_params(wide, 1, device="cpu")
    blk = p["blocks"][0]
    for t, std in ((blk["wq"], 1 / 16), (blk["wi_gate"], 1 / 16),
                   (blk["wo"], 1 / 32), (blk["wo_ffn"], 1 / 32),
                   (p["embed"], 0.02), (p["lm_head"], 1 / 16)):
        assert abs(float(t.float().std()) / std - 1) < 0.05
    assert float(blk["bq"].abs().max()) == 0.0
    assert float(blk["attn_norm"].min()) == 1.0


# ---------------------------------------------------------------------------
# Prefill and paged decode


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_prefill_full_matches_reference(full, jax_impl, request):
    if jax_impl == "pallas":
        request.getfixturevalue("pallas_interpret")
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S = 40 if full else 24          # neither a multiple of the kernel tile
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                             impl=jax_impl)
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(tokens)},
                                impl=impl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        _close(tl, jl, f"logits ({impl})")
        _close(tc["k"], jc["k"], f"cache k ({impl})")
        _close(tc["v"], jc["v"], f"cache v ({impl})")
        assert _np(tc["pos"]).tolist() == _np(jc["pos"]).tolist()


def _decode_setup(cfg, jp, jcfg, S, slots, live, steps):
    """Prefill ``live`` prompts of S tokens (JAX), lay their KV out in a
    block pool at shuffled block ids with room for ``steps`` more tokens;
    slots past ``live`` stay inactive (trash-block tables, pos 0)."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (live, S))
    logits, cache = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    Lr = cfg.num_layers
    nb_live = -(-(S + steps) // Bs)
    nb = 1
    while nb < nb_live:
        nb *= 2
    N = 1 + Lr * live * nb_live
    ids = rng.permutation(np.arange(1, N)).astype(np.int32)
    tables = np.zeros((Lr, slots, nb), np.int32)
    tables[:, :live, :nb_live] = ids.reshape(Lr, live, nb_live)
    pool = {kk: np.zeros((N, Bs, cfg.padded_kv_heads, cfg.dh), np.float32)
            for kk in ("k", "v")}
    Sb = -(-S // Bs) * Bs
    for kk in ("k", "v"):
        c = np.asarray(cache[kk])                       # [L, live, S, H, dh]
        c = np.pad(c, ((0, 0), (0, 0), (0, Sb - S), (0, 0), (0, 0)))
        blocks = c.reshape(Lr, live, Sb // Bs, Bs, *c.shape[3:])
        pool[kk][tables[:, :live, :Sb // Bs]] = blocks
    toks = np.zeros(slots, np.int32)
    toks[:live] = np.asarray(jnp.argmax(logits, -1))
    pos = np.zeros(slots, np.int32)
    pos[:live] = S
    return pool, tables, pos, toks


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_decode_step_paged_matches_reference(full, jax_impl, request):
    if jax_impl == "pallas":
        request.getfixturevalue("pallas_interpret")
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, slots, live, steps = (21, 3, 2, 4) if not full else (13, 2, 1, 3)
    pool, tables, pos, toks = _decode_setup(cfg, jp, jcfg, S, slots, live,
                                            steps)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpools = {impl: {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
              for impl in ("kernel", "plain")}
    tbl_j, tbl_t = jnp.asarray(tables), torch.from_numpy(tables)
    for step in range(steps):
        jl, jpool, _ = JT.decode_step_paged(
            jp, jcfg, jpool, tbl_j, jnp.asarray(pos), jnp.asarray(toks),
            impl=jax_impl)
        for impl, tpool in tpools.items():
            tl, out_pool, new_pos = T.decode_step_paged(
                tp, cfg, tpool, tbl_t, torch.from_numpy(pos),
                torch.from_numpy(toks), impl=impl)
            assert out_pool is tpool            # updated in place
            assert _np(new_pos).tolist() == (pos + 1).tolist()
            assert tl.dtype == torch.float32
            _close(tl, jl, f"step {step} logits ({impl})")
        # live slots advance; inactive ones stay on the trash block at 0
        toks[:live] = np.asarray(jnp.argmax(jl, -1))[:live]
        pos[:live] += 1
    for impl, tpool in tpools.items():
        for kk in ("k", "v"):      # every live block; block 0 is trash
            _close(tpool[kk][1:], np.asarray(jpool[kk])[1:],
                   f"pool {kk} ({impl})")


# ---------------------------------------------------------------------------
# Dense decode, chunked prefill (dense and paged)


def _torch_cache(cache):
    return {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}


@pytest.mark.parametrize("full", [False, True])
def test_decode_step_matches_reference(full):
    """Dense decode over several steps from a JAX prefill cache, with
    per-slot positions: one live slot at the prompt's end, one earlier
    (stale KV past it is masked, then overwritten), one past the capacity
    (writes clamp to C-1, every column valid)."""
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, C, steps = (13, 24, 4) if not full else (9, 16, 3)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, S))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                             capacity=C)
    jc = dict(jc, pos=jnp.asarray([S, 5, C + 2], jnp.int32))
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    tcaches = {impl: _torch_cache(jc) for impl in ("kernel", "plain")}
    for step in range(steps):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks))
        for impl, tc in tcaches.items():
            k_before = tc["k"]
            tl, tcaches[impl] = T.decode_step(tp, cfg, tc,
                                              torch.from_numpy(toks),
                                              impl=impl)
            assert tcaches[impl]["k"] is k_before   # updated in place
            assert tl.dtype == torch.float32
            _close(tl, jl, f"step {step} logits ({impl})")
            assert _np(tcaches[impl]["pos"]).tolist() == \
                _np(jc["pos"]).tolist()
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for impl, tc in tcaches.items():
        for kk in ("k", "v"):
            _close(tc[kk], jc[kk], f"cache {kk} ({impl})")


def test_init_cache_matches_reference():
    jcfg, cfg = _configs(False)
    jc = JT.init_cache(jcfg, 3, 20)
    tc = T.init_cache(cfg, 3, 20, device="cpu")
    assert set(tc) == set(jc)
    for key, leaf in jc.items():
        assert tuple(tc[key].shape) == leaf.shape, key
        assert float(tc[key].abs().max()) == 0.0
    assert tc["pos"].dtype == torch.int32 and tc["k"].dtype == torch.float32


@pytest.mark.parametrize("full", [False, True])
def test_prefill_chunked_matches_reference(full):
    """Fresh chunked prefill, and a resume from a cached prefix
    (``cache=``/``start=``), against the reference's; the resumed logits
    also match the fresh ones."""
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, chunk, C, start = (24, 8, 32, 16) if not full else (32, 16, 48, 16)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, S))
    jl, jc = JT.prefill_chunked(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                chunk, capacity=C)
    _, jpre = JT.prefill_chunked(
        jp, jcfg, {"tokens": jnp.asarray(tokens[:, :start])}, chunk,
        capacity=C)
    jlr, jcr = JT.prefill_chunked(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                  chunk, capacity=C, cache=jpre, start=start)
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens)}, chunk, capacity=C, impl=impl)
        _close(tl, jl, f"fresh logits ({impl})")
        for kk in ("k", "v"):
            _close(tc[kk], jc[kk], f"fresh cache {kk} ({impl})")
        assert _np(tc["pos"]).tolist() == _np(jc["pos"]).tolist() == [S]
        _, tpre = T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens[:, :start])}, chunk, capacity=C, impl=impl)
        tlr, tcr = T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens)}, chunk, capacity=C, impl=impl, cache=tpre, start=start)
        _close(tlr, jlr, f"resumed logits ({impl})")
        _close(tlr, jl, f"resumed vs fresh logits ({impl})")
        for kk in ("k", "v"):
            _close(tcr[kk], jcr[kk], f"resumed cache {kk} ({impl})")
    with pytest.raises(ValueError):             # not in whole chunks
        T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens[:, :S - 1])}, chunk, capacity=C)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_prefill_chunked_paged_matches_reference(full, jax_impl, request):
    """Chunked prefill straight into shuffled pool blocks, fresh and
    resumed after a prefix (``start=``), against the reference's ``xla``
    and ``pallas`` (interpret) branches; the blocks the chunks wrote hold
    the same KV."""
    if jax_impl == "pallas":
        request.getfixturevalue("pallas_interpret")
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, chunk = (24, 8) if not full else (48, 16)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (1, S))
    Lr, nbk = cfg.num_layers, S // Bs
    N = 1 + Lr * nbk + 5
    tables = rng.permutation(np.arange(1, N))[:Lr * nbk].astype(
        np.int32).reshape(Lr, nbk)
    pool = {kk: np.zeros((N, Bs, cfg.padded_kv_heads, cfg.dh), np.float32)
            for kk in ("k", "v")}
    jl, jpool = JT.prefill_chunked_paged(
        jp, jcfg, {"tokens": jnp.asarray(tokens)}, chunk,
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        impl=jax_impl)
    for impl in ("kernel", "plain"):
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        tl, out = T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens)}, chunk, tpool,
            torch.from_numpy(tables), impl=impl)
        assert out is tpool
        _close(tl, jl, f"logits ({impl})")
        for kk in ("k", "v"):
            _close(tpool[kk][tables], np.asarray(jpool[kk])[tables],
                   f"blocks {kk} ({impl})")
        # resume: the prefix's blocks already hold its KV
        start = chunk
        rpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens[:, :start])}, chunk,
            rpool, torch.from_numpy(tables[:, :start // Bs]), impl=impl)
        rl, _ = T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens)}, chunk, rpool,
            torch.from_numpy(tables), start=start, impl=impl)
        _close(rl, jl, f"resumed logits ({impl})")
        for kk in ("k", "v"):
            _close(rpool[kk][tables], np.asarray(jpool[kk])[tables],
                   f"resumed blocks {kk} ({impl})")


def test_gather_scatter_blocks_match_reference():
    rng = np.random.default_rng(4)
    pool = {kk: rng.standard_normal((9, Bs, 2, 4)).astype(np.float32)
            for kk in ("k", "v")}
    ids = np.array([[3, 5], [8, 1]], np.int32)
    got = T.gather_blocks({k: torch.from_numpy(v) for k, v in pool.items()},
                          torch.from_numpy(ids))
    want = JT.gather_blocks({k: jnp.asarray(v) for k, v in pool.items()},
                            jnp.asarray(ids))
    for kk in ("k", "v"):
        _close(got[kk], want[kk], f"gather {kk}")
    dst = {kk: np.zeros_like(v) for kk, v in pool.items()}
    tdst = {k: torch.from_numpy(v.copy()) for k, v in dst.items()}
    out = T.scatter_blocks(tdst, torch.from_numpy(ids), got)
    assert out is tdst                          # in place
    want = JT.scatter_blocks({k: jnp.asarray(v) for k, v in dst.items()},
                             jnp.asarray(ids), want)
    for kk in ("k", "v"):
        np.testing.assert_array_equal(_np(tdst[kk]), np.asarray(want[kk]))


def test_bf16_logits_are_float32():
    """bf16 weights and activations, fp32 logits (as the reference's
    ``preferred_element_type=f32`` einsum): greedy ties must not drift."""
    cfg = get_smoke_config("qwen2.5-3b")
    p = T.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 9),
                           generator=torch.Generator().manual_seed(0))
    logits, cache = T.prefill_full(p, cfg, {"tokens": tokens})
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert cache["k"].dtype == torch.bfloat16
    assert not T.supports_paged(cfg.replace(sliding_window=16))
    assert not T.supports_paged(cfg.replace(kv_quant=True))


@pytest.mark.parametrize("change,slice_name", [
    # the kv-quant slice has landed: an int8 cache with its scales
    pytest.param({"kv_quant": True}, None, id="change0-kv-quant slice"),
    ({"sliding_window": 16}, "a later slice"),
    # the MoE slice has landed: an MoE config is accepted
    pytest.param({"moe": MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)},
                 None, id="change2-MoE slice"),
    # the hybrid slice has landed: a windowless hybrid block is accepted
    pytest.param({"block": "hybrid"}, None, id="change3-hybrid slice"),
])
def test_unported_configs_name_their_slice(change, slice_name):
    cfg = get_smoke_config("qwen2.5-3b").replace(**change)
    if slice_name is None:
        assert T.unported(cfg) is None
        cache = T.init_cache(cfg, 1, 8, device="cpu")
        assert cache["k"].shape[2] == 8
        if "kv_quant" in change:
            assert cache["k"].dtype == torch.int8
            assert cache["k_scale"].shape == (2, 1, 8, 1)
            return
        leaf = "moe" if "moe" in change else "ssm"
        assert leaf in T.init_params(cfg, 0, device="cpu")["blocks"][0]
        assert ("ssm_h" in cache) == (leaf == "ssm")
        return
    assert slice_name in T.unported(cfg)
    with pytest.raises(NotImplementedError, match=slice_name):
        T.init_cache(cfg, 1, 8, device="cpu")
    assert T.unported(get_smoke_config("qwen2.5-3b")) is None


# ---------------------------------------------------------------------------
# RWKV-6 (the WKV kernel's family)
#
# The reference initialises w_lora_b to 0 and ln_x to 1, so at init the decay
# is a constant and the group norm's scale is 1: a fault in either could not
# show. Every RWKV parity test draws both with numpy and gives the same
# arrays to both packages. In bfloat16 the two frameworks round at other
# places (matmul outputs, the shift difference, tanh), and over 2 layers and
# the LM head that moves the logits by up to ~3% of their scale: the bf16 tests
# hold logits and state to 5e-2 of their scale.

BF16_TOL = 5e-2


def _rwkv_params(dtype: str):
    jcfg = jax_get_smoke("rwkv6-1.6b").replace(dtype=dtype)
    cfg = get_smoke_config("rwkv6-1.6b").replace(dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    blocks = dict(jp["blocks"])
    wb = blocks["w_lora_b"]
    blocks["w_lora_b"] = jnp.asarray(
        rng.standard_normal(wb.shape) * 0.3, jnp.float32).astype(wb.dtype)
    lx = blocks["ln_x"]
    blocks["ln_x"] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(lx.shape),
                                 jnp.float32)
    jp = dict(jp, blocks=blocks)
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _close_tol(got, want, tol, what):
    got = _np(got.float() if torch.is_tensor(got) else got).astype(np.float32)
    want = np.asarray(want).astype(np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_rwkv_block_matches_reference(jax_impl):
    """``rwkv_block`` and ``rwkv_block_step`` (both impls) against the
    reference's block (chunked jnp, or the Pallas kernel in interpret
    mode) and its step, from a nonzero state, with a nonzero decay LoRA and
    a non-unit group-norm scale: the counterpart of
    ``test_rwkv_block_pallas_matches_xla``. float32: 1e-4 of the scale."""
    jcfg, cfg, jp, tp = _rwkv_params("float32")
    B, S, D, H = 2, 21, cfg.d_model, cfg.num_heads
    N = D // H
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    st = {"s": (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32),
          "tm_x": rng.standard_normal((B, D)).astype(np.float32),
          "cm_x": rng.standard_normal((B, D)).astype(np.float32)}
    jpl = {k: v[1] for k, v in jp["blocks"].items()}
    jy, jst = JR.rwkv_block(jpl, jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in st.items()}, jcfg,
                            impl=jax_impl, interpret=True)
    jy1, jst1 = JR.rwkv_block_step(jpl, jnp.asarray(x1), jst, jcfg)
    for impl in ("kernel", "plain"):
        tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        s_before = tst["s"]
        ty, tst = R.rwkv_block(tp["blocks"][1], torch.from_numpy(x), tst,
                               cfg, impl=impl)
        assert tst["s"] is s_before                 # updated in place
        _close(ty, jy, f"block ({impl})")
        for k in st:
            _close(tst[k], jst[k], f"block state {k} ({impl})")
        ty1, tst = R.rwkv_block_step(tp["blocks"][1], torch.from_numpy(x1),
                                     tst, cfg, impl=impl)
        _close(ty1, jy1, f"step ({impl})")
        for k in st:
            _close(tst[k], jst1[k], f"step state {k} ({impl})")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_prefill_decode_match_reference(dtype):
    """``prefill_full`` then dense ``decode_step``s on the RWKV smoke
    config, from converted weights: logits and the per-layer state against
    the reference at every step, for both impls (float32: 1e-4 of the
    scale; bfloat16: ``BF16_TOL``)."""
    jcfg, cfg, jp, tp = _rwkv_params(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 19))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                             capacity=64)
    keys = ("s", "tm_x", "cm_x")
    tcaches = {}
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(
            tokens)}, capacity=64, impl=impl)
        assert tl.dtype == torch.float32 and set(tc) == set(jc)
        assert tc["s"].dtype == torch.float32
        assert tc["tm_x"].dtype == cfg.tdtype
        _close_tol(tl, jl, tol, f"prefill logits ({impl})")
        for k in keys:
            _close_tol(tc[k], jc[k], tol, f"prefill {k} ({impl})")
        assert _np(tc["pos"]).tolist() == [19] * 3
        tcaches[impl] = tc
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(3):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks))
        for impl, tc in tcaches.items():
            s_before = tc["s"]
            tl, tcaches[impl] = T.decode_step(tp, cfg, tc,
                                              torch.from_numpy(toks),
                                              impl=impl)
            assert tcaches[impl]["s"] is s_before       # updated in place
            _close_tol(tl, jl, tol, f"step {step} logits ({impl})")
            for k in keys:
                _close_tol(tcaches[impl][k], jc[k], tol,
                           f"step {step} {k} ({impl})")
            assert _np(tcaches[impl]["pos"]).tolist() == \
                _np(jc["pos"]).tolist()
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_rwkv_init_params_and_cache_match_reference():
    """Same leaf names, shapes and dtypes as the reference's init (``w0``,
    ``u`` and ``ln_x`` fp32 in a bf16 config), the reference's constants
    and scales, and an ``init_cache`` of the reference's layout; the
    converter keeps each leaf's own dtype."""
    jcfg, cfg = jax_get_smoke("rwkv6-1.6b"), get_smoke_config("rwkv6-1.6b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.init_params(cfg, 0, device="cpu")
    conv = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    assert set(p) == set(jp) == set(conv)
    assert len(p["blocks"]) == cfg.num_layers
    assert set(p["blocks"][0]) == set(jp["blocks"])
    for name, leaf in jp["blocks"].items():
        for got in (p["blocks"][0][name], conv["blocks"][0][name]):
            assert tuple(got.shape) == leaf.shape[1:], name
            assert _dtype_name(got) == leaf.dtype.name, name
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(p[name].shape) == jp[name].shape, name
    blk = p["blocks"][0]
    assert blk["w0"].dtype == blk["u"].dtype == blk["ln_x"].dtype == \
        torch.float32
    assert torch.equal(blk["w0"], torch.full_like(blk["w0"], -0.6))
    assert float(blk["w_lora_b"].abs().max()) == 0.0
    assert float(blk["ln_x"].min()) == float(blk["ln_x"].max()) == 1.0
    assert 0.0 <= float(blk["mu"].min()) and float(blk["mu"].max()) < 1.0
    wide = cfg.replace(d_model=256, num_heads=4, num_kv_heads=4, d_ff=896)
    wblk = T.init_params(wide, 1, device="cpu")["blocks"][0]
    assert abs(float(wblk["u"].std()) / 0.5 - 1) < 0.05
    assert abs(float(wblk["wr"].float().std()) * 16 - 1) < 0.05
    jc = JT.init_cache(jcfg, 3, 20)
    tc = T.init_cache(cfg, 3, 20, device="cpu")
    assert set(tc) == set(jc) == {"s", "tm_x", "cm_x", "pos"}
    for key, leaf in jc.items():
        assert tuple(tc[key].shape) == leaf.shape, key
        assert _dtype_name(tc[key]) == leaf.dtype.name, key
        assert float(tc[key].abs().max()) == 0.0


def test_rwkv_refuses_chunked_prefill_and_paging():
    """RWKV prefill is never chunked (the reference asserts it) and its
    O(1) state has no paged layout."""
    cfg = get_smoke_config("rwkv6-1.6b")
    p = T.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 16), dtype=torch.long)
    assert not T.supports_paged(cfg) and T.unported(cfg) is None
    with pytest.raises(ValueError, match="chunked prefill"):
        T.prefill_chunked(p, cfg, {"tokens": tokens}, 8)
    with pytest.raises(ValueError, match="chunked prefill"):
        T.prefill_chunked_paged(p, cfg, {"tokens": tokens}, 8, {}, None)
    with pytest.raises(ValueError, match="paged layout"):
        T.decode_step_paged(p, cfg, {}, None, None, tokens[:, 0])


def _jamba_smoke():
    # one period of Jamba's 8 layers: attention in layer 4, experts in the
    # odd layers
    return ModelConfig(
        name="jamba-smoke", family="hybrid", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128,
        dtype="bfloat16", block="jamba", attn_layer_period=8,
        attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        rope=False, ssm_expand=2, ssm_dt_rank=4, ssm_conv_bias=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=48,
                      capacity_factor=8.0, router_experts=16,
                      renormalize=False))


@pytest.mark.parametrize("arch", ARCH_IDS + ("jamba-smoke",))
def test_the_table_of_mixers_agrees_with_every_cache(arch):
    """Each layer's kind (``ModelConfig.mixer``) names an entry of
    ``MIXERS`` and agrees with the attention and Mamba-1 layer ids; the
    entries each layer's mixer keeps, stacked over the layers that keep
    them, are what ``init_slot_state``, ``init_cache`` and a prefill's
    cache hold, for the full configuration (on the meta device) and the
    smoke one."""
    cfgs = ((_jamba_smoke(),) if arch == "jamba-smoke"
            else (get_config(arch), get_smoke_config(arch)))
    for cfg in cfgs:
        kinds = [cfg.mixer(i) for i in range(cfg.num_layers)]
        assert set(kinds) <= set(T.MIXERS), kinds
        assert cfg.attn_layer_ids == tuple(
            i for i, k in enumerate(kinds) if T.MIXERS[k].attends)
        assert cfg.mamba_layer_ids == tuple(
            i for i, k in enumerate(kinds) if k == "mamba")
        kv = ("k", "v") + (("k_scale", "v_scale") if cfg.kv_quant else ())
        depth = {}
        for k in kinds:
            for key in (kv if T.MIXERS[k].attends else ()) + \
                    T.MIXERS[k].state:
                depth[key] = depth.get(key, 0) + 1
        assert T.cache_stacks(cfg) == depth
        slot = T.init_slot_state(cfg, 3, device="meta")
        assert {k: tuple(t.shape[:2]) for k, t in slot.items()} == {
            k: (n, 3) for k, n in depth.items() if k not in kv}
        if all("dense" in T.MIXERS[k].paths for k in kinds):
            cache = T.init_cache(cfg, 3, 8, device="meta")
            assert {k: tuple(t.shape[:2]) for k, t in cache.items()
                    if k != "pos"} == {k: (n, 3) for k, n in depth.items()}
        else:
            with pytest.raises(ValueError, match="paged layout only"):
                T.init_cache(cfg, 3, 8, device="meta")
    # the smoke configuration, the loop's last, at its ``depth``
    params = T.init_params(cfg, 0, device="cpu")
    _, cache = T.prefill_full(params, cfg, {"tokens": torch.zeros(
        (2, 8), dtype=torch.long)}, impl="plain")
    assert {k: tuple(t.shape[:2]) for k, t in cache.items()
            if k != "pos"} == {k: (n, 2) for k, n in depth.items()}
