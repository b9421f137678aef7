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
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = 1e-4
Bs = 8


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
    jcfg = (jax_get_config if full else jax_get_smoke)("qwen2.5-3b")
    cfg = (get_config if full else get_smoke_config)("qwen2.5-3b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("dh", "q_group", "padded_heads", "padded_kv_heads",
                 "padded_vocab", "can_group_decode", "is_attention_free",
                 "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    for fn in ("param_count", "active_param_count", "kv_bytes_per_token"):
        assert getattr(cfg, fn)() == getattr(jcfg, fn)(), fn
    assert cfg.tdtype == torch.bfloat16
    if full:        # the figures the port's docs quote
        assert cfg.kv_bytes_per_token() == 36_864
        assert round(cfg.param_count() / 1e9, 2) == 3.40


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
    ({"kv_quant": True}, "kv-quant / sliding-window slice"),
    ({"sliding_window": 16}, "kv-quant / sliding-window slice"),
    ({"block": "rwkv"}, "RWKV-6 slice"),
    ({"block": "hybrid"}, "hybrid slice"),
])
def test_unported_configs_name_their_slice(change, slice_name):
    cfg = get_smoke_config("qwen2.5-3b").replace(**change)
    assert slice_name in T.unported(cfg)
    with pytest.raises(NotImplementedError, match=slice_name):
        T.init_cache(cfg, 1, 8, device="cpu")
    assert T.unported(get_smoke_config("qwen2.5-3b")) is None
