"""The port's int8 KV cache (kv-quant), its verify pass and speculative
decoding against the JAX package on the CPU, on the same weights (the JAX
parameters carried across by ``repro_torch.convert``) and the same
numpy-made tokens.

Tolerances:

- ``_kv_quantize`` on the same rows is bit-identical: both divide by the
  same fp32 scale and round half to even.
- A model's K/V differ between XLA and PyTorch in their last fp32 bits, so
  a value next to a rounding boundary may land one int8 code apart:
  caches agree within one code, their bf16 scales within one bf16 ulp
  (2^-7 relative).
- Logits: kv-quant against the unquantized path within the reference's own
  bound (0.08, ``tests/test_models.py``); the port's kv-quant logits within
  1e-3 of the reference's scale (a code's worth of one K or V element,
  1/127 of its row's amax, weighted by its attention probability).
- Token streams and speculation's tokens and ``stats`` are equal: greedy
  argmax over float32 logits that are nowhere near a tie at this size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import transformer as JT
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Engine as JEngine
from repro.serving.speculative import speculative_decode as jspeculative
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.core.hardware import get_chip
from repro_torch.models import transformer as T
from repro_torch.serving.backends import make_engine
from repro_torch.serving.cluster import Cluster, kv_bytes
from repro_torch.serving.speculative import speculative_decode
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   StaticWorkload, materialize)

LOGIT_TOL = 1e-3
# tests/test_models.py::test_kv_quant_decode_close_to_fp's bound
QUANT_BOUND = 0.08


def _configs(full: bool, **kw):
    """(JAX config, port config), float32: the smoke configuration, or
    qwen2.5-3b's head geometry (16/2 heads of 128) at 2 layers with a
    narrow FFN and vocabulary."""
    kw = dict(dtype="float32", **kw)
    if full:
        kw.update(num_layers=2, d_ff=256, vocab_size=512)
        return (jax_get_config("qwen2.5-3b").replace(**kw),
                get_config("qwen2.5-3b").replace(**kw))
    return (jax_get_smoke("qwen2.5-3b").replace(**kw),
            get_smoke_config("qwen2.5-3b").replace(**kw))


_PARAMS = {}


def _params(full: bool):
    if full not in _PARAMS:
        jcfg, _ = _configs(full)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[full] = jp, from_reference(jax.tree.map(np.asarray, jp),
                                           device="cpu")
    return _PARAMS[full]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


def _rows(dtype: str) -> np.ndarray:
    """Rows of 16 in float32: random of several scales, all-zero rows (the
    1e-8 floor), rows whose amax is 127 (scale exactly 1) holding halves
    (ties, rounded to even), and rows at the clip."""
    rng = np.random.default_rng(11)
    rows = [rng.standard_normal(16) * s for s in (1e-3, 0.3, 1.0, 50.0)]
    rows += [np.zeros(16), np.full(16, 1e-12)]
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -126.5,
                       126.5, 64.5, -64.5, 0.0, 7.5, -7.5, 8.5])
    rows += [halves, -halves, halves * 2.0, halves / 4.0]
    out = np.stack(rows).astype(np.float32)
    if dtype == "bfloat16":     # the values a bf16 model hands over
        out = np.array(jnp.asarray(out).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    return out.reshape(2, -1, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_is_bit_identical_to_reference(dtype):
    rows = _rows(dtype)
    jq, js = JT._kv_quantize(jnp.asarray(rows).astype(dtype))
    tq, ts = T._kv_quantize(torch.from_numpy(rows).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), _np(js))
    # ties to even and the floor, spelled out on the scale-1 rows
    assert tq.reshape(-1, 16)[6, :4].tolist() == [127, 0, 2, 2]
    assert float(ts.reshape(-1)[4]) == pytest.approx(1e-8, rel=1e-2)
    for dt in (jnp.float32, jnp.bfloat16):
        deq = T._kv_dequant(tq, ts, getattr(torch, jnp.dtype(dt).name))
        np.testing.assert_array_equal(
            _np(deq), _np(JT._kv_dequant(jq, js, dt)))


@pytest.mark.parametrize("full", [False, True])
def test_kv_quant_prefill_and_decode_match_reference(full):
    """Prefill (attending over unquantized K/V, caching int8) grown to a
    capacity, then dense decode steps, both impls: within the reference's
    bound of the unquantized logits, within ``LOGIT_TOL`` of the
    reference's kv-quant logits, the int8 caches within one code."""
    jcfg, cfg = _configs(full, kv_quant=True)
    jp, tp = _params(full)
    S, C, steps = (13, 20, 3) if not full else (9, 16, 3)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S + 1))
    lg_fp, _ = JT.prefill_full(jp, jcfg.replace(kv_quant=False),
                               {"tokens": jnp.asarray(toks)})
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             capacity=C)
    assert jc["k"].dtype == jnp.int8
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(
            toks[:, :S])}, capacity=C, impl=impl)
        assert set(tc) == set(jc)
        assert tc["k"].dtype == torch.int8 and tc["k"].shape[2] == C
        assert tuple(tc["k_scale"].shape) == jc["k_scale"].shape
        assert tc["k_scale"].dtype == torch.bfloat16
        _close(tl, jl, LOGIT_TOL, f"prefill ({impl})")
        jcs, tcs, nxt = jc, tc, toks[:, S]
        for step in range(steps):
            jlg, jcs = JT.decode_step(jp, jcfg, jcs, jnp.asarray(nxt))
            tlg, tcs = T.decode_step(tp, cfg, tcs, torch.from_numpy(nxt),
                                     impl=impl)
            _close(tlg, jlg, LOGIT_TOL, f"decode step {step} ({impl})")
            if step == 0:       # the reference's own check, on the port
                err = float(np.abs(_np(tlg) - _np(lg_fp)).max())
                assert err < QUANT_BOUND, err
            nxt = np.asarray(jnp.argmax(jlg, -1)).astype(np.int64)
        for kk in ("k", "v"):
            codes = np.abs(tcs[kk].numpy().astype(np.int32)
                           - np.asarray(jcs[kk]).astype(np.int32))
            assert codes.max() <= 1, (kk, codes.max())
            got, want = _np(tcs[kk + "_scale"]), _np(jcs[kk + "_scale"])
            assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), kk
        assert tcs["pos"].tolist() == np.asarray(jcs["pos"]).tolist()


def test_kv_quant_keeps_the_reference_limits():
    """kv-quant has no paged layout, no chunked prefill (dense or paged)
    and no verify pass, as the reference asserts; a window stays refused
    on the attn block."""
    _, cfg = _configs(False, kv_quant=True)
    _, tp = _params(False)
    assert T.unported(cfg) is None and not T.supports_paged(cfg)
    toks = {"tokens": torch.zeros((1, 16), dtype=torch.long)}
    with pytest.raises(ValueError, match="bf16 KV"):
        T.prefill_chunked(tp, cfg, toks, 8, capacity=24, impl="plain")
    pool = T.init_block_pool(cfg.replace(kv_quant=False), 8, 8, device="cpu")
    with pytest.raises(ValueError, match="bf16 KV"):
        T.prefill_chunked_paged(tp, cfg, toks, 8, pool,
                                torch.zeros((2, 2), dtype=torch.int32))
    cache = T.init_cache(cfg, 1, 24, device="cpu")
    with pytest.raises(ValueError, match="bf16 KV"):
        T.verify_chunk(tp, cfg, cache, toks["tokens"][:, :4], 0)
    with pytest.raises(ValueError, match="paged KV unsupported"):
        make_engine("torch", 0, cfg, tp, slots=2, capacity=24, paged=True,
                    device="cpu")
    assert "later slice" in T.unported(cfg.replace(sliding_window=8))
    assert "attn block only" in T.unported(
        cfg.replace(block="hybrid", sliding_window=8))


def _requests(jax_side: bool, vocab: int, n: int, isl: int, osl: int):
    mods = ((jmaterialize, JOpenLoopWorkload, JBurst, JFixedShape)
            if jax_side else
            (materialize, OpenLoopWorkload, Burst, FixedShape))
    mat, wl, burst, shape = mods
    return mat(wl(burst(n), shape(isl, osl), vocab=vocab, seed=3,
                  max_requests=n, horizon_s=3600.0))


@pytest.mark.parametrize("full", [False, True])
def test_kv_quant_disagg_serve_matches_reference(full):
    """A kv-quant disaggregated serve on dense engines (1 prefill + 1
    decode, 2 slots): the reference's greedy streams, its transfer count
    and bytes; each handoff the int8 values and bf16 scales of the
    capacity-wide cache, (1 + 2/dh) / 2 of a bf16 cache's bytes — 130/256
    at dh 128."""
    jcfg, cfg = _configs(full, kv_quant=True)
    jp, tp = _params(full)
    n, isl, osl = 4, 12, 5
    cap = isl + osl + 8
    jreqs = _requests(True, cfg.vocab_size, n, isl, osl)
    treqs = _requests(False, cfg.vocab_size, n, isl, osl)
    jeng = [JEngine(i, jcfg, jp, slots=2, capacity=cap) for i in (0, 100)]
    jcl = JCluster({"prefill": jeng[:1], "decode": jeng[1:]})
    jcl.serve(JStaticWorkload(jreqs))
    teng = [make_engine("torch", i, cfg, tp, slots=2, capacity=cap,
                        chip=get_chip("h100"), device="cpu")
            for i in (0, 100)]
    assert not any(e.paged for e in teng)
    tcl = Cluster({"prefill": teng[:1], "decode": teng[1:]})
    tm = tcl.serve(StaticWorkload(treqs))
    assert tm["completed"] == n
    assert {r.rid: r.output for r in treqs} == \
        {r.rid: r.output for r in jreqs}
    assert tcl.stats.transfers == jcl.stats.transfers == n
    assert tcl.stats.transferred_bytes == jcl.stats.transferred_bytes
    bf16 = cfg.num_layers * cap * cfg.num_kv_heads * cfg.dh * 2 * 2
    assert tcl.stats.transferred_bytes * 2 * cfg.dh == \
        n * bf16 * (cfg.dh + 2)
    if full:
        assert cfg.dh == 128
        assert tcl.stats.transferred_bytes * 256 == n * bf16 * 130
    # one prefill's payload, walked as the cluster walks it
    _, payload = teng[0].prefill(np.arange(isl) % cfg.vocab_size)
    assert kv_bytes(payload) * 2 * cfg.dh == bf16 * (cfg.dh + 2)


def test_kv_quant_insert_pads_the_scales():
    """A prefill cache narrower than the decode engine's is zero-padded to
    its width, the scales with the values (and one wider is cut)."""
    _, cfg = _configs(False, kv_quant=True)
    _, tp = _params(False)
    eng = make_engine("torch", 0, cfg, tp, slots=2, capacity=24,
                      device="cpu")
    for width in (10, 30):
        _, src = T.prefill_full(tp, cfg, {"tokens": torch.arange(
            10)[None] % cfg.vocab_size}, capacity=width, impl="plain")

        class Req:
            slot = engine_id = None
        slot = eng.insert(Req(), src)
        w = min(width, 24)
        for kk in ("k", "v", "k_scale", "v_scale"):
            row = eng.cache[kk][:, slot]
            assert torch.equal(row[:, :w], src[kk][:, 0, :w]), kk
            assert not row[:, w:].any(), kk
        eng.evict(slot)


# ---------------------------------------------------------------------------
# the verify pass and speculative decoding


@pytest.mark.parametrize("full", [False, True])
def test_verify_chunk_matches_reference(full):
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, C, k = 11, 24, 4
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, S + k))
    _, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                            capacity=C)
    jl, jc = JT.verify_chunk(jp, jcfg, jc, jnp.asarray(toks[:, S:]), S)
    for impl in ("kernel", "plain"):
        _, tc = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(
            toks[:, :S])}, capacity=C, impl=impl)
        k_before = tc["k"]
        tl, tc = T.verify_chunk(tp, cfg, tc, torch.from_numpy(toks[:, S:]),
                                S, impl=impl)
        assert tc["k"] is k_before                  # written in place
        assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
        _close(tl, jl, 1e-4, f"verify logits ({impl})")
        _close(tc["k"], jc["k"], 1e-4, f"verify cache ({impl})")
        assert tc["pos"].tolist() == [S + k]
    with pytest.raises(ValueError, match="attention family"):
        T.verify_chunk(None, get_smoke_config("rwkv6-1.6b"), None,
                       torch.zeros((1, 4), dtype=torch.long), 0)


def _draft(jp, tp, jcfg, cfg, depth):
    """A cut-depth draft: the target's first ``depth`` blocks, its embed,
    final norm and head."""
    jd = dict(jp, blocks=jax.tree.map(lambda a: a[:depth], jp["blocks"]))
    td = dict(tp, blocks=tp["blocks"][:depth])
    return (jd, jcfg.replace(num_layers=depth),
            td, cfg.replace(num_layers=depth))


def _greedy(tp, cfg, prompt, n):
    lg, c = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(prompt)[None]},
                           capacity=len(prompt) + n + 8, impl="plain")
    out = [int(lg[0, :cfg.vocab_size].argmax())]
    while len(out) < n:
        lg, c = T.decode_step(tp, cfg, c, torch.tensor([out[-1]]),
                              impl="plain")
        out.append(int(lg[0, :cfg.vocab_size].argmax()))
    return out


@pytest.mark.parametrize("draft", ["self", "cut-depth"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_speculative_decode_matches_reference(draft, impl):
    """The reference's tokens and ``stats`` exactly, and the target's own
    greedy decode: the self-draft accepts every proposal; the 1-layer
    draft of the 2-layer target is rejected and re-prefilled."""
    jcfg, cfg = _configs(False)
    jp, tp = _params(False)
    if draft == "self":
        jd, jdc, td, tdc = jp, jcfg, tp, cfg
    else:
        jd, jdc, td, tdc = _draft(jp, tp, jcfg, cfg, 1)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, 12).astype(np.int32)
    N, k = 12, 4
    jtoks, jstats = jspeculative(jp, jcfg, jd, jdc, prompt, N, k=k)
    toks, stats = speculative_decode(tp, cfg, td, tdc, prompt, N, k=k,
                                     impl=impl)
    assert toks == jtoks and stats == jstats
    assert toks == _greedy(tp, cfg, prompt, N)
    if draft == "self":
        assert stats["accepted"] == stats["proposed"]
    else:
        assert stats["accepted"] < stats["proposed"]
    assert stats["draft_calls"] == k * (stats["target_calls"] - 1)
