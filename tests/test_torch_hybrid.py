"""The port's hybrid family (hymba-1.5b: sliding-window attention beside a
selective SSM, over a ring-buffer KV cache) vs the JAX package on the CPU,
on the same weights and numpy-made inputs: the SSM branch, the windowed
attention, the ring decode, the model, the engines and the launcher.

Tolerance: float32 throughout, where the two packages differ only in
summation order: XLA's einsums vs PyTorch's matmuls, XLA's
``associative_scan`` (a tree) vs the port's doubling scan, the reference's
two-chunk banded attention vs one masked softmax. Those move the outputs
by ~1e-6 of their scale; 1e-4 of the scale leaves room for the layers and
the LM head to compound them, as ``test_torch_model.py`` holds. The SSM
state ``conv`` is a slice of the inputs, so it is compared exactly.
Greedy token streams are compared exactly (float32 logits nowhere near a
tie at this size, as ``test_torch_serving.py``). One test runs bf16: the
port's drift from float32 is held to twice the reference's own.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Engine as JEngine
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import Poisson as JPoisson
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving.cluster import Cluster, kv_bytes
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request
from repro_torch.workloads import (FixedShape, OpenLoopWorkload, Poisson,
                                   StaticWorkload, materialize)

ARCH = "hymba-1.5b"
TOL = 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _close(got, want, what, tol=TOL):
    got, want = _np(got).astype(np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs():
    """(JAX config, port config) of hymba's smoke size in float32."""
    return (jax_get_smoke(ARCH).replace(dtype="float32"),
            get_smoke_config(ARCH).replace(dtype="float32"))


def _weights(jcfg, seed=0):
    """The reference's init, and the same weights carried to the port."""
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# The configuration and the parameters


def test_hymba_config_mirrors_reference():
    for full in (True, False):
        jcfg = (jax_get_config if full else jax_get_smoke)(ARCH)
        cfg = (get_config if full else get_smoke_config)(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for fn in ("param_count", "active_param_count", "kv_bytes_per_token"):
            assert getattr(cfg, fn)() == getattr(jcfg, fn)(), fn
    cfg = get_config(ARCH)
    assert ARCH in ARCH_IDS and T.unported(cfg) is None
    assert not T.supports_paged(cfg)
    assert (cfg.num_layers, cfg.d_model, cfg.dh, cfg.q_group,
            cfg.sliding_window) == (32, 1600, 64, 5, 1024)
    assert cfg.param_count() == 1_392_286_400


def test_init_params_and_convert_keep_hybrid_layout():
    """The reference's hybrid init: its leaves (the nested ``ssm`` dict,
    the two output norms), fp32 ``dt_bias``/``A_log``/``D_skip`` in a bf16
    config, the SSM's constants and scales; ``from_reference`` keeps the
    nesting, each leaf's dtype and its values."""
    jcfg, cfg = jax_get_smoke(ARCH), get_smoke_config(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.init_params(cfg, 0, device="cpu")
    conv = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    for got in (p, conv):
        assert set(got) == set(jp) and len(got["blocks"]) == cfg.num_layers
        blk = got["blocks"][1]
        assert set(blk) == set(jp["blocks"])
        assert set(blk["ssm"]) == set(jp["blocks"]["ssm"])
        for name, leaf in jp["blocks"]["ssm"].items():
            assert tuple(blk["ssm"][name].shape) == leaf.shape[1:], name
            assert str(blk["ssm"][name].dtype).split(".")[1] == \
                leaf.dtype.name, name
        for name in ("dt_bias", "A_log", "D_skip"):
            assert blk["ssm"][name].dtype == torch.float32, name
            np.testing.assert_array_equal(
                _np(blk["ssm"][name]), np.asarray(jp["blocks"]["ssm"][name])[1])
        assert blk["ssm"]["in_proj"].dtype == torch.bfloat16
        assert blk["attn_out_norm"].dtype == torch.bfloat16
    for name in ("in_proj", "conv_w", "out_proj"):
        np.testing.assert_array_equal(
            _np(conv["blocks"][0]["ssm"][name].float()),
            np.asarray(jp["blocks"]["ssm"][name][0].astype(jnp.float32)))

    def count(tree):
        return sum(count(t) if isinstance(t, dict) else t.numel()
                   for t in tree.values())
    n = count({k: v for k, v in p.items() if k != "blocks"}) + sum(
        count(b) for b in p["blocks"])
    # the analytic count (the reference's) takes A_log [di, ds] and
    # dt_bias for 2 * di values and leaves out the two output norms
    di = cfg.ssm_expand * cfg.d_model
    assert n == cfg.param_count() + cfg.num_layers * (
        di * cfg.ssm_state + 2 * cfg.d_model)
    wide = cfg.replace(d_model=256, num_heads=4, num_kv_heads=2)
    ssm_p = T.init_params(wide, 1, device="cpu")["blocks"][0]["ssm"]
    for name, std in (("in_proj", 1 / 16), ("x_proj", 1 / 16),
                      ("out_proj", 1 / 16), ("conv_w", 0.5)):
        assert abs(float(ssm_p[name].float().std()) / std - 1) < 0.1, name


# ---------------------------------------------------------------------------
# The SSM branch


def test_softplus_matches_jax_above_torch_threshold():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 1e-3, 3.0, 19.9, 20.0, 20.5,
                  35.0, 88.0], np.float32)
    _close(S.softplus(_t(x)), np.asarray(jax.nn.softplus(jnp.asarray(x))),
           "softplus", tol=1e-6)


def test_scan_chunk_matches_sequential_recurrence():
    """The doubling scan against the recurrence one position at a time, at
    a chunk that is no power of two."""
    rng = np.random.default_rng(5)
    a = _t(rng.uniform(0.2, 1.0, (2, 37, 3, 4)).astype(np.float32))
    b = _t(rng.standard_normal((2, 37, 3, 4)).astype(np.float32))
    h = h0 = _t(rng.standard_normal((2, 3, 4)).astype(np.float32))
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    h_all, h_last = S._scan_chunk(a, b, h0)
    _close(h_all, _np(torch.stack(want, 1)), "h_all", tol=1e-5)
    _close(h_last, _np(want[-1]), "h_last", tol=1e-5)


@pytest.mark.parametrize("S_", [40, 256, 300, 600])
@pytest.mark.parametrize("from_zero", [True, False])
def test_ssm_apply_and_step_match_reference(S_, from_zero):
    """``ssm_apply`` over one chunk, exactly one, a padded second and three,
    from a zero and a non-zero state; then ``ssm_step`` over 8 tokens from
    its state: outputs and both state leaves."""
    jcfg, cfg = _configs()
    jp = JS.init_ssm(jax.random.PRNGKey(2), jcfg)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(S_)
    B, D = 2, cfg.d_model
    di = cfg.ssm_expand * D
    x = rng.standard_normal((B, S_, D)).astype(np.float32)
    if from_zero:
        h0 = np.zeros((B, di, cfg.ssm_state), np.float32)
        c0 = np.zeros((B, cfg.ssm_conv - 1, di), np.float32)
    else:
        h0 = rng.standard_normal((B, di, cfg.ssm_state)).astype(np.float32)
        c0 = rng.standard_normal((B, cfg.ssm_conv - 1, di)).astype(
            np.float32)
    jy, js = JS.ssm_apply(jp, jnp.asarray(x), {"h": jnp.asarray(h0),
                                               "conv": jnp.asarray(c0)}, jcfg)
    ty, ts = S.ssm_apply(tp, _t(x), {"h": _t(h0), "conv": _t(c0)}, cfg)
    _close(ty, jy, "y")
    _close(ts["h"], js["h"], "h")
    np.testing.assert_array_equal(_np(ts["conv"]), np.asarray(js["conv"]))
    for step in range(8):
        x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
        jy, js = JS.ssm_step(jp, jnp.asarray(x1), js, jcfg)
        ty, ts = S.ssm_step(tp, _t(x1), ts, cfg)
        _close(ty, jy, f"step {step} y")
        _close(ts["h"], js["h"], f"step {step} h")
        np.testing.assert_array_equal(_np(ts["conv"]),
                                      np.asarray(js["conv"]))


def test_ssm_state_init_shapes_and_types():
    cfg = get_smoke_config(ARCH)
    st = S.init_ssm_state(cfg, 3, device="cpu")
    assert st["h"].shape == (3, 64, 4) and st["h"].dtype == torch.float32
    assert st["conv"].shape == (3, 3, 64)
    assert st["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The windowed attention and the ring


@pytest.mark.parametrize("S_,W", [(12, 16), (16, 16), (37, 16), (48, 16),
                                  (70, 32)])
def test_flash_ref_window_matches_sliding_window_xla(S_, W):
    """The plain windowed flash attention (the kernel's oracle) against the
    reference's banded ``sliding_window_attention_xla`` at S <= W (plain
    causal), S = 2W + 5, a multiple of W and a ragged S, with GQA."""
    rng = np.random.default_rng(S_ + W)
    B, H, Hkv, dh = 2, 4, 2, 16
    q = rng.standard_normal((B, S_, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S_, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S_, Hkv, dh)).astype(np.float32)
    want = JL.sliding_window_attention_xla(
        jnp.asarray(q), jnp.asarray(np.repeat(k, H // Hkv, axis=2)),
        jnp.asarray(np.repeat(v, H // Hkv, axis=2)), W)
    for fn in (flash_attention_ref, flash_attention):
        got = fn(_t(q), _t(k), _t(v), causal=True, window=W)
        _close(got, np.asarray(want), f"{fn.__name__} S={S_} W={W}")


def test_flash_window_at_an_offset_and_refusals():
    """With ``q_offset`` the band follows the rows' absolute positions (the
    reference's dense oracle with ``window``); a window past every row's
    past changes nothing; a window without causal, or below 0, raises."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 10, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, q_offset=30,
                          window=7)
    want = JL.dense_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=2)),
        jnp.asarray(np.repeat(v, 2, axis=2)), causal=True, window=7,
        kv_offset=30)
    _close(got, np.asarray(want), "q_offset 30, window 7")
    full = flash_attention(_t(q), _t(k), _t(v), causal=True, q_offset=30)
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), causal=True,
                                       q_offset=30, window=40), full)
    for kw in ({"causal": False, "window": 4}, {"window": -1}):
        with pytest.raises(ValueError, match="window"):
            flash_attention(_t(q), _t(k), _t(v), **kw)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_attn_decode_ring_wraps_like_reference(impl):
    """Single-token attention on the W-row ring, slots at positions before,
    at and past the wrap (3, 15, 16, 17, 40): the output and both caches
    against the reference's ``attn_decode`` on the same ring."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    W, B = cfg.sliding_window, 5
    rng = np.random.default_rng(4)
    pos = np.array([3, 15, 16, 17, 40], np.int32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, W, cfg.num_kv_heads, cfg.dh)).astype(
        np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"])
    jo, (jk, jv, _) = JT.attn_decode(jblk, jnp.asarray(x1), jcfg,
                                     jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(pos))
    tk, tv = _t(kc), _t(vc)
    to, _ = T.attn_decode(tp["blocks"][0], _t(x1), cfg, tk, tv, _t(pos),
                          impl=impl)
    _close(to, jo, "attn out")
    _close(tk, jk, "k ring")
    _close(tv, jv, "v ring")
    assert int(np.abs(_np(tk) - kc).sum(axis=(2, 3)).astype(bool).sum()) \
        == B                                    # one slot written per row
    with pytest.raises(ValueError, match="ring"):
        T.attn_decode(tp["blocks"][0], _t(x1), cfg, _t(kc[:, :8]),
                      _t(vc[:, :8]), _t(pos), impl=impl)


# ---------------------------------------------------------------------------
# The model


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_hymba_prefill_and_decode_match_reference(impl):
    """hymba-smoke: a 40-token prefill over a window of 16 (the ring rolled
    by (40 - 16) % 16), then 12 decode steps (the ring wraps again): logits
    and every cache leaf (ring K/V, ssm_h, conv, pos) at each step."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 40))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = T.prefill_full(tp, cfg, {"tokens": _t(toks)}, impl=impl)
    _close(tl, jl, "prefill logits")
    assert set(tc) == set(jc) == {"k", "v", "ssm_h", "conv", "pos"}
    assert tc["k"].shape == (2, 2, 16, 2, 16)
    for key in jc:
        _close(tc[key], jc[key], f"prefill {key}")
    for step in range(12):
        nxt = rng.integers(0, cfg.vocab_size, (2,))
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = T.decode_step(tp, cfg, tc, _t(nxt), impl=impl)
        _close(tl, jl, f"decode {step} logits")
        for key in jc:
            _close(tc[key], jc[key], f"decode {step} {key}")


def test_hymba_short_prompt_pads_the_ring():
    """A prompt shorter than the window lands at slots 0..S-1 of a
    zero-padded ring, as the reference places it; decoding fills the rest."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    toks = np.arange(1, 10)[None]
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = T.prefill_full(tp, cfg, {"tokens": _t(toks)}, impl="kernel")
    _close(tl, jl, "logits")
    for key in jc:
        _close(tc[key], jc[key], key)
    assert float(tc["k"][:, :, 9:].abs().max()) == 0.0


def test_hymba_full_head_geometry_matches_reference():
    """hymba's own heads (25 query / 5 KV heads of 64, G = 5, d_model
    1600) at 2 layers with a narrow FFN and vocabulary and a window of 64:
    a 150-token prefill and 3 decode steps against the reference."""
    cut = dict(num_layers=2, d_ff=256, vocab_size=512, sliding_window=64,
               dtype="float32")
    jcfg = jax_get_config(ARCH).replace(**cut)
    cfg = get_config(ARCH).replace(**cut)
    jp, tp = _weights(jcfg, seed=1)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (1, 150))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = T.prefill_full(tp, cfg, {"tokens": _t(toks)}, impl="kernel")
    _close(tl, jl, "prefill logits")
    for step in range(3):
        nxt = rng.integers(0, 512, (1,))
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = T.decode_step(tp, cfg, tc, _t(nxt), impl="kernel")
        _close(tl, jl, f"decode {step} logits")
    for key in jc:
        _close(tc[key], jc[key], key)


def test_bf16_drift_from_fp32_follows_reference():
    """In bfloat16 the hybrid block's normed branch merge lets rounding
    compound from layer to layer: at 8 layers of the smoke width both
    packages' bf16 logits drift from their float32 logits (the same
    weights) by several percent of the scale. The port's drift stays
    within twice the reference's plus 1e-2 of the scale (the rule the
    card holds the kernel path to, here between the packages)."""
    jcfg = jax_get_smoke(ARCH).replace(num_layers=8)
    cfg = get_smoke_config(ARCH).replace(num_layers=8)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    jl, _ = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    want, _ = JT.prefill_full(jp32, jcfg.replace(dtype="float32"),
                              {"tokens": jnp.asarray(toks)})
    tl, _ = T.prefill_full(tp, cfg, {"tokens": _t(toks)}, impl="kernel")
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    ref_drift = float(np.abs(np.asarray(jl) - want).max()) / scale
    port_drift = float(np.abs(_np(tl) - want).max()) / scale
    assert port_drift <= 2 * ref_drift + 1e-2, (port_drift, ref_drift)


@pytest.mark.parametrize("layers", [2, 4])
def test_bf16_drift_at_hymba_width_follows_reference(layers):
    """At hymba's own width (d_model 1600, 25/5 heads of 64, d_ff 5504,
    the full vocabulary and window), the depth cut to run on the CPU, and
    a 1,100-token prompt past the window (the card's model check): the
    reference's bf16 logits sit percent of the scale off its own float32
    logits (about 1.8% at 2 layers, 3.0% at 4), and the port's bf16 on the
    same weights stays within twice that plus 1e-2 of the scale."""
    jcfg = jax_get_config(ARCH).replace(num_layers=layers)
    cfg = get_config(ARCH).replace(num_layers=layers)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1100))
    jl, _ = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    want, _ = JT.prefill_full(jax.tree.map(lambda a: a.astype(jnp.float32),
                                           jp), jcfg.replace(dtype="float32"),
                              {"tokens": jnp.asarray(toks)})
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    del jp
    with torch.inference_mode():
        tl, _ = T.prefill_full(tp, cfg, {"tokens": _t(toks)}, impl="plain")
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    ref_drift = float(np.abs(np.asarray(jl, np.float32) - want).max()) / scale
    port_drift = float(np.abs(_np(tl.float()) - want).max()) / scale
    print(f"hymba width, {layers} layers, S=1100: bf16 vs fp32 / scale: "
          f"reference {ref_drift:.4f}, port {port_drift:.4f}")
    assert ref_drift >= 1e-2, ref_drift
    assert port_drift <= 2 * ref_drift + 1e-2, (port_drift, ref_drift)


def test_windowless_hybrid_decodes_like_reference():
    """A hybrid block without a window (qwen2.5's smoke heads): its cache is
    capacity-wide, written at min(pos, C-1); decode steps from the empty
    cache against the reference's."""
    kw = dict(block="hybrid", dtype="float32")
    jcfg = jax_get_smoke("qwen2.5-3b").replace(**kw)
    cfg = get_smoke_config("qwen2.5-3b").replace(**kw)
    jp, tp = _weights(jcfg)
    jc = JT.init_cache(jcfg, 2, 8)
    tc = T.init_cache(cfg, 2, 8, device="cpu")
    assert tc["k"].shape[2] == 8 and set(tc) == set(jc)
    rng = np.random.default_rng(8)
    for step in range(10):                  # past the capacity: clamps
        nxt = rng.integers(0, cfg.vocab_size, (2,))
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = T.decode_step(tp, cfg, tc, _t(nxt), impl="plain")
        _close(tl, jl, f"decode {step} logits")
    for key in jc:
        _close(tc[key], jc[key], key)


def test_hybrid_refuses_chunked_prefill_and_paged_layout():
    cfg = get_smoke_config(ARCH)
    p = T.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        T.prefill_chunked(p, cfg, {"tokens": torch.zeros((1, 16),
                                                         dtype=torch.long)}, 8)
    pool = T.init_block_pool(cfg, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        T.decode_step_paged(p, cfg, pool, torch.zeros((2, 1, 1),
                                                      dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.long))


# ---------------------------------------------------------------------------
# Serving: the ring and the SSM state handed over


@pytest.fixture(scope="module")
def hymba_weights():
    jcfg, cfg = _configs()
    return (jcfg, cfg) + _weights(jcfg)


def _requests(jax_side: bool, vocab: int):
    if jax_side:
        return jmaterialize(JOpenLoopWorkload(
            JPoisson(100.0), JFixedShape(24, 6), vocab=vocab, seed=8,
            max_requests=4, horizon_s=5.0))
    return materialize(OpenLoopWorkload(
        Poisson(100.0), FixedShape(24, 6), vocab=vocab, seed=8,
        max_requests=4, horizon_s=5.0))


def _handoff_bytes(cfg) -> int:
    """One request's payload: the ring K and V, ssm_h fp32 and conv."""
    di = cfg.ssm_expand * cfg.d_model
    return cfg.num_layers * (
        2 * cfg.sliding_window * cfg.num_kv_heads * cfg.dh
        * cfg.tdtype.itemsize + di * cfg.ssm_state * 4
        + (cfg.ssm_conv - 1) * di * cfg.tdtype.itemsize)


def test_hymba_engines_stream_like_reference(hymba_weights):
    """The reference's hybrid serve (1 prefill + 1 dense decode engine, 2
    slots, capacity 38, not the window's 16): the same greedy streams on
    the same float32 weights and the same transferred bytes, the ring and
    the SSM state per request whatever the prompt."""
    jcfg, cfg, jp, tp = hymba_weights
    jreqs, treqs = _requests(True, cfg.vocab_size), _requests(
        False, cfg.vocab_size)
    jeng = [JEngine(i, jcfg, jp, slots=2, capacity=38) for i in (0, 1)]
    jcl = JCluster({"prefill": jeng[:1], "decode": jeng[1:]})
    assert jcl.serve(JStaticWorkload(jreqs))["completed"] == 4
    teng = [Engine(i, cfg, tp, slots=2, capacity=38, device="cpu")
            for i in (0, 1)]
    assert not any(e.paged for e in teng)
    tcl = Cluster({"prefill": teng[:1], "decode": teng[1:]})
    assert tcl.serve(StaticWorkload(treqs))["completed"] == 4
    assert {r.rid: list(r.output) for r in treqs} == \
        {r.rid: list(r.output) for r in jreqs}
    assert all(len(r.output) == 6 for r in treqs)
    assert tcl.stats.transfers == jcl.stats.transfers == 4
    assert tcl.stats.transferred_bytes == jcl.stats.transferred_bytes \
        == 4 * _handoff_bytes(cfg)


@pytest.mark.parametrize("capacity", [8, 40])
def test_insert_keeps_the_whole_ring(hymba_weights, capacity):
    """A hymba prefill handed to a dense engine whose capacity is below or
    above the window: every row of the W-row ring arrives, as the
    reference's insert pads or cuts to the destination cache's own width,
    and the SSM state arrives whole; the other slot is left alone."""
    _, cfg, _, tp = hymba_weights
    pre = Engine(0, cfg, tp, slots=1, capacity=capacity, device="cpu")
    dec = Engine(1, cfg, tp, slots=2, capacity=capacity, device="cpu")
    prompt = np.arange(1, 30, dtype=np.int32)
    _, payload = pre.prefill(prompt)
    assert payload["k"].shape[2] == cfg.sliding_window
    assert dec.cache["k"].shape[2] == cfg.sliding_window
    assert kv_bytes(payload) == _handoff_bytes(cfg)
    before = {k: v.clone() for k, v in dec.cache.items()}
    slot = dec.insert(Request(rid=0, prompt=prompt, osl=2), payload)
    for key in ("k", "v", "ssm_h", "conv"):
        assert float(payload[key].abs().min(dim=2).values.max()) > 0.0, key
        assert torch.equal(dec.cache[key][:, slot], payload[key][:, 0]), key
        assert torch.equal(dec.cache[key][:, 1 - slot],
                           before[key][:, 1 - slot]), key
    assert int(dec.cache["pos"][slot]) == len(prompt)


def test_hymba_engine_is_dense_without_prefix_cache(hymba_weights):
    _, cfg, _, tp = hymba_weights
    eng = Engine(0, cfg, tp, slots=2, capacity=32, chunk_size=8,
                 device="cpu")
    assert not eng.paged and eng.prefix_cache is None
    assert set(eng.cache) == {"k", "v", "ssm_h", "conv", "pos"}
    with pytest.raises(ValueError, match="paged"):
        Engine(2, cfg, tp, paged=True, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.prefill_chunked(np.arange(16, dtype=np.int32), 8)


def _serve(*args, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    if not check:
        return out
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def test_launcher_serves_hymba_smoke_on_cpu():
    """``--arch hymba-1.5b --smoke --device cpu`` serves disaggregated: every
    request completes and each handoff is the ring and the SSM state
    (6,912 bytes in bf16), whatever the prompt; chunked modes are
    refused at start-up."""
    rec = _serve("--requests", "4", "--isl", "32", "--osl", "6")
    assert rec["completed"] == 4 and rec["arch"] == "hymba-smoke"
    assert rec["mode"] == "disagg" and rec["prefills"] == 4
    assert _handoff_bytes(get_smoke_config(ARCH)) == 6912
    assert rec["transferred_MB"] * 2**20 == rec["transfers"] * 6912
    out = _serve("--mode", "coloc", check=False)
    assert out.returncode == 2 and "never chunked" in out.stderr
