"""The port's MoE (``repro_torch.models.moe``) and the MoE family served
(granite-moe-1b-a400m) vs the JAX package on the CPU, on the same weights
and numpy-made inputs.

Tolerance: float32 throughout, where the two packages differ only in
summation order (XLA's einsums and scatter-add vs PyTorch's matmuls and
the port's gather-sum combine): 1e-4 of the output's scale, as
``test_torch_model.py``.
Routing is discrete, so it is compared exactly: each MoE call's token ->
expert mask (the top-k sets) and its dropped count must be equal on both
sides; an output can only agree within the tolerance if they are.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention.ops as jax_dec_ops
import repro.kernels.flash_attention.ops as jax_flash_ops
import repro.models.moe as JM
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import transformer as JT
from repro.models.config import MoEConfig as JMoEConfig
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Engine as JEngine
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.config import MoEConfig
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import Engine
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   StaticWorkload, materialize)

ARCH = "granite-moe-1b-a400m"
TOL = 1e-4
Bs = 8
ROOT = pathlib.Path(__file__).resolve().parents[1]
# drops happen: C = ceil(0.5 * T * k / E) slots per expert hold only half
# of the assignments of a balanced router
DROPPY = dict(num_experts=8, top_k=2, d_ff_expert=16, capacity_factor=0.5,
              min_capacity=1)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _close(got, want, what, tol=TOL):
    got, want = _np(got).astype(np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# The MoE functions


def test_granite_config_mirrors_reference():
    for full in (True, False):
        jcfg = (jax_get_config if full else jax_get_smoke)(ARCH)
        cfg = (get_config if full else get_smoke_config)(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for fn in ("param_count", "active_param_count", "kv_bytes_per_token"):
            assert getattr(cfg, fn)() == getattr(jcfg, fn)(), fn
    cfg = get_config(ARCH)
    assert ARCH in ARCH_IDS and "kimi-k2-1t-a32b" in ARCH_IDS
    # kimi-k2 is registered (the simulator and the sweep price it); its
    # 1T parameters exceed one card, so the torch backend refuses its full
    # size before allocating anything, and serves its smoke configuration
    from argparse import Namespace
    from repro_torch.launch.serve import torch_refusal
    serve_args = Namespace(mode="disagg", scheduler="fcfs")
    assert "repro_torch.launch.dryrun --arch kimi-k2-1t-a32b" in \
        torch_refusal(get_config("kimi-k2-1t-a32b"), serve_args)
    assert torch_refusal(get_smoke_config("kimi-k2-1t-a32b"),
                         serve_args) is None
    assert T.unported(cfg) is None and T.supports_paged(cfg)
    assert (cfg.dh, cfg.q_group, cfg.padded_vocab) == (64, 2, 49168)
    assert cfg.param_count() == 1_384_963_072
    assert cfg.kv_bytes_per_token() == 49_152      # the handoff per token


@pytest.mark.parametrize("cf,min_cap", [(0.5, 1), (1.25, 8), (2.0, 8),
                                        (1.0, 1), (1.25, 200)])
def test_expert_capacity_matches_reference(cf, min_cap):
    """The float formula, ceil, then the min_capacity and min(T, .)
    clamps, over token counts that hit each clamp."""
    for E, k in ((8, 2), (32, 8), (384, 8)):
        m = dict(num_experts=E, top_k=k, d_ff_expert=8, capacity_factor=cf,
                 min_capacity=min_cap)
        for n in (1, 2, 7, 8, 9, 63, 64, 100, 512, 4096):
            assert M.expert_capacity(n, MoEConfig(**m)) == \
                JM.expert_capacity(n, JMoEConfig(**m)), (m, n)
    g = get_config(ARCH).moe      # the serve's shapes (ISSUE: C per call)
    assert [M.expert_capacity(n, g) for n in (8, 64, 512)] == [8, 20, 160]


def test_top_k_breaks_ties_like_reference():
    """``jax.lax.top_k`` puts the lower index first among equal values;
    the port's stable descending sort does the same (``torch.topk``
    promises no order)."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 32)).astype(np.float32) / 4
    probs[0] = 0.25                                 # all equal
    for k in (1, 4, 8, 32):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = M.top_k(_t(probs), k)
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))


def test_route_exact_tie_picks_the_lowest_experts():
    """x = 0 gives every expert the same probability: both packages route
    every token to experts 0..k-1 with gates 1/k."""
    cfg = get_config(ARCH).moe
    x = np.zeros((5, 16), np.float32)
    w = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    jg, jm, _, _ = JM._route(jnp.asarray(x), jnp.asarray(w), cfg)
    tg, tm, _, _ = M._route(_t(x), _t(w), cfg)
    want = np.zeros((5, 32), np.int32)
    want[:, :cfg.top_k] = 1
    np.testing.assert_array_equal(np.asarray(jm), want)
    np.testing.assert_array_equal(_np(tm), want)
    _close(tg, np.asarray(jg), "gates")
    assert float(tg[:, :cfg.top_k].min()) == 1.0 / cfg.top_k


def _moe_inputs(m: MoEConfig, T_, D, seed, shared=False):
    rng = np.random.default_rng(seed)
    F, E = m.d_ff_expert, m.num_experts
    x = rng.standard_normal((T_, D)).astype(np.float32)
    w = {"router": rng.standard_normal((D, E)) * 0.5,
         "wg": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wu": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wd": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if shared:
        Fs = F * m.num_shared_experts
        w.update(shared_wg=rng.standard_normal((D, Fs)) / np.sqrt(D),
                 shared_wu=rng.standard_normal((D, Fs)) / np.sqrt(D),
                 shared_wd=rng.standard_normal((Fs, D)) / np.sqrt(Fs))
    return x, {k: v.astype(np.float32) for k, v in w.items()}


def test_route_matches_reference():
    m = MoEConfig(num_experts=32, top_k=8, d_ff_expert=8)
    x, w = _moe_inputs(m, 50, 24, 2)
    jg, jm, jaux, jz = JM._route(jnp.asarray(x), jnp.asarray(w["router"]),
                                 JMoEConfig(**dataclasses.asdict(m)))
    tg, tm, taux, tz = M._route(_t(x), _t(w["router"]), m)
    assert tm.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))    # top_ids
    _close(tg, jg, "gates")
    _close(taux, jaux, "aux loss")
    _close(tz, jz, "z loss")


@pytest.mark.parametrize("combine_fp32", [True, False])
@pytest.mark.parametrize("T_", [40, 7])
def test_local_moe_drops_like_reference(T_, combine_fp32):
    """Capacity 0.5 with min_capacity 1: experts overflow and drop pairs.
    The same pairs drop on both sides (the count, and the outputs that
    depend on which), and the combine matches."""
    m = MoEConfig(**DROPPY)
    x, w = _moe_inputs(m, T_, 32, 3)
    jy, jaux = JM._local_moe(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in ("router", "wg", "wu",
                                                       "wd")),
        cfg=JMoEConfig(**DROPPY), ep_axis=None, dp_axes=(),
        combine_fp32=combine_fp32)
    ty, taux = M._local_moe(_t(x), *(_t(w[k]) for k in ("router", "wg", "wu",
                                                        "wd")),
                            cfg=m, combine_fp32=combine_fp32)
    assert float(taux["moe_dropped"]) == float(jaux["moe_dropped"]) > 0
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    _close(ty, jy, "y")
    for k in ("moe_aux_loss", "moe_z_loss"):
        _close(taux[k], jaux[k], k)


def test_moe_ffn_shared_expert_matches_reference():
    m = MoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                  num_shared_experts=2)
    x, w = _moe_inputs(m, 10, 32, 4, shared=True)
    x = x.reshape(2, 5, 32)
    jy, jaux = JM.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in w.items()},
                          JMoEConfig(**dataclasses.asdict(m)),
                          expert_tp=True)
    ty, taux = M.moe_ffn(_t(x), {k: _t(v) for k, v in w.items()}, m,
                         expert_tp=True)
    assert tuple(ty.shape) == (2, 5, 32)
    _close(ty, jy, "moe_ffn with shared experts")
    assert float(taux["moe_dropped"]) == float(jaux["moe_dropped"])
    # the shared branch is live: without it the output moves
    plain, _ = M.moe_ffn(_t(x), {k: _t(v) for k, v in w.items()},
                         dataclasses.replace(m, num_shared_experts=0))
    assert float((plain - ty).abs().max()) > 1e-2


def test_moe_ffn_in_bf16_rounds_where_the_reference_does():
    """bf16 activations and experts, fp32 router and combine: silu in
    fp32 cast to bf16 before ``* u``, the combine cast at the end. The two
    frameworks' bf16 products round alike here; held to bf16's 2^-8."""
    m = MoEConfig(**DROPPY)
    x, w = _moe_inputs(m, 24, 32, 5)
    jw = {k: jnp.asarray(v).astype(jnp.float32 if k == "router"
                                   else jnp.bfloat16) for k, v in w.items()}
    tw = {k: _t(v).to(torch.float32 if k == "router" else torch.bfloat16)
          for k, v in w.items()}
    jx = jnp.asarray(x).astype(jnp.bfloat16)[None]
    jy, jaux = JM.moe_ffn(jx, jw, JMoEConfig(**DROPPY))
    ty, taux = M.moe_ffn(_t(x).to(torch.bfloat16)[None], tw, m)
    assert ty.dtype == torch.bfloat16
    assert float(taux["moe_dropped"]) == float(jaux["moe_dropped"])
    _close(ty.float(), np.asarray(jy.astype(jnp.float32)), "bf16 y",
           tol=2 ** -7)


# the grouped dispatch's cases: (MoEConfig keywords, first expert held,
# tokens; the router pushed by one feature: expert -> logit weight)
GROUPED = {
    "dropless": (dict(num_experts=8, top_k=2, d_ff_expert=16,
                      capacity_factor=4.0), 0, 40, {}),
    "drops": (DROPPY, 0, 40, {}),
    "jamba_held_0_7": (dict(num_experts=8, top_k=2, d_ff_expert=16,
                            capacity_factor=8.0, router_experts=16,
                            renormalize=False), 0, 48, {}),
    "jamba_held_8_15": (dict(num_experts=8, top_k=2, d_ff_expert=16,
                             capacity_factor=8.0, router_experts=16,
                             first_expert=8, renormalize=False), 8, 48, {}),
    "top1": (dict(num_experts=8, top_k=1, d_ff_expert=16,
                  capacity_factor=8.0), 0, 40, {}),
    "top8": (dict(num_experts=16, top_k=8, d_ff_expert=16,
                  capacity_factor=2.0), 0, 24, {}),
    "an_expert_without_rows": (dict(num_experts=8, top_k=2, d_ff_expert=16,
                                    capacity_factor=4.0), 0, 40, {3: -100.0}),
    "every_pair_to_one_expert": (dict(num_experts=8, top_k=1,
                                      d_ff_expert=16, capacity_factor=8.0),
                                 0, 40, {5: 100.0}),
    "one_expert_over_capacity": (dict(num_experts=8, top_k=1,
                                      d_ff_expert=16, capacity_factor=2.0,
                                      min_capacity=1), 0, 40, {5: 100.0}),
}


@pytest.mark.parametrize("combine_fp32", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GROUPED))
def test_grouped_dispatch_matches_reference(case, dtype, combine_fp32):
    """``_local_moe(grouped=True)`` (each held expert over its kept rows
    only) against the JAX package's ``_local_moe`` on the same inputs: the
    same token -> expert mask and dropped count exactly, the losses and
    the output within TOL of their scale in float32 and within the bf16
    tolerance of ``test_moe_ffn_in_bf16_rounds_where_the_reference_does``
    in bfloat16. Jamba's held half (a router over 16 experts, 8 held, the
    gates not renormalised) has no counterpart there: those cases hold
    the grouped call to the port's padded one, the same drops and losses
    exactly and the output within 1e-6 of its scale in float32 (the
    products' summation order is all that differs). One grouped call is
    counted."""
    kw, e_off, T_, push = GROUPED[case]
    m = MoEConfig(**kw)
    x, w = _moe_inputs(m, T_, 32, 6)
    router = np.random.default_rng(7).standard_normal(
        (32, m.routed)).astype(np.float32) * 0.5
    x[:, 0] = 10.0
    for e, v in push.items():
        router[0, e] = v
    dt = getattr(torch, dtype)
    args = (_t(x).to(dt), _t(router),
            *(_t(w[k]).to(dt) for k in ("wg", "wu", "wd")))
    before = M.grouped_calls
    got, got_aux = M._local_moe(*args, cfg=m, combine_fp32=combine_fp32,
                                e_off=e_off, grouped=True)
    assert M.grouped_calls == before + 1
    mask = M._route(args[0], args[1], m)[1]
    if case == "an_expert_without_rows":
        assert int(mask[:, 3].sum()) == 0
    if case.startswith("every_pair") or case.startswith("one_expert"):
        assert int(mask[:, 5].sum()) == T_
    if case in ("drops", "one_expert_over_capacity"):
        assert float(got_aux["moe_dropped"]) > 0
    assert got.dtype == (torch.float32 if combine_fp32 else dt)
    assert tuple(got.shape) == (T_, 32)
    bf16 = dtype == "bfloat16"
    if case.startswith("jamba"):
        want, want_aux = M._local_moe(*args, cfg=m, e_off=e_off,
                                      combine_fp32=combine_fp32)
        for k in ("moe_dropped", "moe_aux_loss", "moe_z_loss"):
            assert torch.equal(got_aux[k], want_aux[k]), k
        _close(got.float(), _np(want.float()), f"grouped {case}",
               tol=2 ** -7 if bf16 else 1e-6)
        return
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    jcfg = JMoEConfig(**kw)
    jmask = JM._route(jx, jnp.asarray(router), jcfg)[1]
    np.testing.assert_array_equal(_np(mask), np.asarray(jmask))
    jy, jaux = JM._local_moe(
        jx, jnp.asarray(router),
        *(jnp.asarray(w[k]).astype(jdt) for k in ("wg", "wu", "wd")),
        cfg=jcfg, ep_axis=None, dp_axes=(), combine_fp32=combine_fp32)
    assert float(got_aux["moe_dropped"]) == float(jaux["moe_dropped"])
    tol = 2 ** -7 if bf16 else TOL
    _close(got.float(), np.asarray(jy.astype(jnp.float32)),
           f"grouped {case}", tol=tol)
    for k in ("moe_aux_loss", "moe_z_loss"):
        _close(got_aux[k], jaux[k], k, tol=tol)


JAMBA_MOE = MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                      capacity_factor=8.0, router_experts=16,
                      renormalize=False)
GRANITE_CELL_MOE = MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                             capacity_factor=4.0)


@pytest.mark.parametrize("what,moe,D,T_,cuda,grad,capturing,want", [
    ("jamba prompt 256", JAMBA_MOE, 4096, 256, True, False, False, False),
    ("jamba prompt 325", JAMBA_MOE, 4096, 325, True, False, False, False),
    ("jamba prompt 326", JAMBA_MOE, 4096, 326, True, False, False, True),
    ("jamba prompt 448", JAMBA_MOE, 4096, 448, True, False, False, True),
    ("jamba prompt 512", JAMBA_MOE, 4096, 512, True, False, False, True),
    ("jamba prompt 1024", JAMBA_MOE, 4096, 1024, True, False, False, True),
    ("jamba prompt 2048", JAMBA_MOE, 4096, 2048, True, False, False, True),
    ("jamba decode 64", JAMBA_MOE, 4096, 64, True, False, True, False),
    ("jamba decode 64 eager", JAMBA_MOE, 4096, 64, True, False, False,
     False),
    ("granite prompt 32", GRANITE_CELL_MOE, 1024, 32, True, False, False,
     False),
    ("granite prompt 128", GRANITE_CELL_MOE, 1024, 128, True, False, False,
     False),
    ("granite decode 256", GRANITE_CELL_MOE, 1024, 256, True, False, True,
     False),
    ("granite prompt 2048", GRANITE_CELL_MOE, 1024, 2048, True, False,
     False, False),
    ("granite prompt 4096", GRANITE_CELL_MOE, 1024, 4096, True, False,
     False, True),
    ("granite prompt 16384", GRANITE_CELL_MOE, 1024, 16384, True, False,
     False, True),
    ("jamba prompt 1024 on the cpu", JAMBA_MOE, 4096, 1024, False, False,
     False, False),
    ("jamba prompt 1024 with grad", JAMBA_MOE, 4096, 1024, True, True,
     False, False),
    ("jamba prompt 1024 under capture", JAMBA_MOE, 4096, 1024, True, False,
     True, False),
])
def test_grouped_pays_where_the_padded_product_is_compute_bound(
        monkeypatch, what, moe, D, T_, cuda, grad, capturing, want):
    """``grouped_pays`` at the cells' shapes and on both sides of its
    lines: a dropless prompt (C = T) on the card takes the grouped
    dispatch where the padded expert product is compute-bound (Jamba from
    326 tokens, granite from 2,186; on the card the grouped way is the
    faster from 256 tokens on for Jamba, and from between 2,048 and 4,096
    for granite); a decode step, a
    short prompt, the CPU, autograd and a graph capture keep the padded
    path. The tokens stand in for a card's tensor (``is_cuda`` and the
    shape are all the rule reads of them)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    x = (types.SimpleNamespace(is_cuda=True, shape=(T_, D)) if cuda
         else torch.zeros((T_, D)))
    assert M.expert_capacity(T_, moe) == T_, what   # dropless
    with torch.set_grad_enabled(grad):
        assert M.grouped_pays(x, moe) is want, what


def test_moe_ffn_keeps_the_padded_path_on_the_cpu(monkeypatch):
    """On the CPU ``moe_ffn`` never takes the grouped dispatch, whatever
    the shape: the count stays, and the output is the padded call's."""
    m = MoEConfig(num_experts=8, top_k=2, d_ff_expert=16,
                  capacity_factor=4.0)
    x, w = _moe_inputs(m, 40, 32, 8)
    before = M.grouped_calls
    with torch.inference_mode():
        y, _ = M.moe_ffn(_t(x)[None], {k: _t(v) for k, v in w.items()}, m)
        want, _ = M._local_moe(_t(x), *(_t(w[k]) for k in (
            "router", "wg", "wu", "wd")), cfg=m)
    assert M.grouped_calls == before
    assert torch.equal(y[0], want)


def test_init_params_and_convert_keep_moe_layout():
    """The reference's MoE init: the same nested leaves under ``moe``, an
    fp32 router in a bf16 config, the scales (router 0.02, experts
    1/sqrt(D), wd also over sqrt(L)); the converter keeps the nesting and
    each leaf's dtype."""
    jcfg, cfg = jax_get_smoke(ARCH), get_smoke_config(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.init_params(cfg, 0, device="cpu")
    conv = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    for got in (p, conv):
        assert set(got) == set(jp) and len(got["blocks"]) == cfg.num_layers
        blk = got["blocks"][1]
        assert set(blk) == set(jp["blocks"])
        assert set(blk["moe"]) == set(jp["blocks"]["moe"])
        for name, leaf in jp["blocks"]["moe"].items():
            assert tuple(blk["moe"][name].shape) == leaf.shape[1:], name
            assert str(blk["moe"][name].dtype).split(".")[1] == \
                leaf.dtype.name, name
        assert blk["moe"]["router"].dtype == torch.float32
        assert blk["moe"]["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(conv["blocks"][1]["moe"]["router"]),
        np.asarray(jp["blocks"]["moe"]["router"])[1])
    n = sum(t.numel() for k, t in p.items() if k != "blocks") + sum(
        t.numel() for b in p["blocks"] for k, t in b.items() if k != "moe"
    ) + sum(t.numel() for b in p["blocks"] for t in b["moe"].values())
    assert n == cfg.param_count()
    wide = cfg.replace(d_model=256, num_layers=4, moe=MoEConfig(
        num_experts=8, top_k=2, d_ff_expert=128, num_shared_experts=1))
    moe = T.init_params(wide, 1, device="cpu")["blocks"][0]["moe"]
    for name, std in (("router", 0.02), ("wg", 1 / 16), ("wu", 1 / 16),
                      ("wd", 1 / 32), ("shared_wg", 1 / 16),
                      ("shared_wd", 1 / 16)):
        assert abs(float(moe[name].float().std()) / std - 1) < 0.05, name


# ---------------------------------------------------------------------------
# granite served: the model functions with routing recorded on both sides


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX model's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(jax_flash_ops, "flash_attention", functools.partial(
        jax_flash_ops.flash_attention, interpret=True))
    monkeypatch.setattr(
        jax_dec_ops, "decode_attention_paged", functools.partial(
            jax_dec_ops.decode_attention_paged, interpret=True))


@pytest.fixture
def routing(monkeypatch):
    """Every MoE call's mask and dropped count, in call order: the JAX side
    through ordered debug callbacks (its layers run under ``lax.scan``),
    the port's directly."""
    rec = {"jax": [], "torch": []}
    j_route, j_local = JM._route, JM._local_moe
    t_route, t_local = M._route, M._local_moe

    def jr(x, router_w, cfg):
        out = j_route(x, router_w, cfg)
        jax.debug.callback(lambda m: rec["jax"].append(("mask", np.array(m))),
                           out[1], ordered=True)
        return out

    def jl(*a, **kw):
        y, aux = j_local(*a, **kw)
        jax.debug.callback(lambda d: rec["jax"].append(("dropped", float(d))),
                           aux["moe_dropped"], ordered=True)
        return y, aux

    def tr(x, router_w, cfg):
        out = t_route(x, router_w, cfg)
        rec["torch"].append(("mask", _np(out[1]).copy()))
        return out

    def tl(*a, **kw):
        y, aux = t_local(*a, **kw)
        rec["torch"].append(("dropped", float(aux["moe_dropped"])))
        return y, aux

    monkeypatch.setattr(JM, "_route", jr)
    monkeypatch.setattr(JM, "_local_moe", jl)
    monkeypatch.setattr(M, "_route", tr)
    monkeypatch.setattr(M, "_local_moe", tl)
    return rec


def _same_routing(rec, what):
    """The port's MoE calls routed and dropped exactly as the reference's;
    clears the port's record for the next impl. Returns the drops."""
    j, t = rec["jax"], rec["torch"]
    assert len(t) == len(j) > 0, (what, len(t), len(j))
    for i, ((kj, vj), (kt, vt)) in enumerate(zip(j, t)):
        assert kj == kt, what
        if kj == "mask":
            np.testing.assert_array_equal(vt, vj, err_msg=f"{what} call {i}")
        else:
            assert vt == vj, (what, i, vt, vj)
    rec["torch"].clear()
    return sum(v for k, v in j if k == "dropped")


def _configs(full: bool):
    """(JAX config, port config), float32. ``full``: granite's widths (d_model
    1024, 16/8 heads of 64, 32 experts top-8 of 512) at 2 layers with a
    512-token vocabulary (its 13 pad rows kept)."""
    if full:
        cut = dict(num_layers=2, vocab_size=512, dtype="float32")
        return (jax_get_config(ARCH).replace(**cut),
                get_config(ARCH).replace(**cut))
    return (jax_get_smoke(ARCH).replace(dtype="float32"),
            get_smoke_config(ARCH).replace(dtype="float32"))


@functools.lru_cache(maxsize=None)
def _params(full: bool):
    jcfg, _ = _configs(full)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_granite_prefill_full_matches_reference(full, jax_impl, request,
                                                routing):
    if jax_impl == "pallas":
        request.getfixturevalue("pallas_interpret")
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S = 40 if full else 24
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                             impl=jax_impl)
    jax.effects_barrier()
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(tokens)},
                                impl=impl)
        _same_routing(routing, f"prefill ({impl})")
        _close(tl, jl, f"logits ({impl})")
        _close(tc["k"], jc["k"], f"cache k ({impl})")
        _close(tc["v"], jc["v"], f"cache v ({impl})")


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
        c = np.asarray(cache[kk])
        c = np.pad(c, ((0, 0), (0, 0), (0, Sb - S), (0, 0), (0, 0)))
        pool[kk][tables[:, :live, :Sb // Bs]] = c.reshape(
            Lr, live, Sb // Bs, Bs, *c.shape[3:])
    toks = np.zeros(slots, np.int32)
    toks[:live] = np.asarray(jnp.argmax(logits, -1))
    pos = np.zeros(slots, np.int32)
    pos[:live] = S
    return pool, tables, pos, toks


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_granite_decode_step_paged_matches_reference(full, jax_impl,
                                                     request, routing):
    """Paged decode steps with inactive slots beside the live ones: every
    slot routes and takes capacity (T = slots), as in the reference."""
    if jax_impl == "pallas":
        request.getfixturevalue("pallas_interpret")
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, slots, live, steps = (21, 3, 2, 3) if not full else (13, 3, 2, 2)
    pool, tables, pos, toks = _decode_setup(cfg, jp, jcfg, S, slots, live,
                                            steps)
    jax.effects_barrier()
    routing["jax"].clear()
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpools = {impl: {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
              for impl in ("kernel", "plain")}
    tbl_j, tbl_t = jnp.asarray(tables), torch.from_numpy(tables)
    for step in range(steps):
        jl, jpool, _ = JT.decode_step_paged(
            jp, jcfg, jpool, tbl_j, jnp.asarray(pos), jnp.asarray(toks),
            impl=jax_impl)
        jax.effects_barrier()
        for impl, tpool in tpools.items():
            tl, _, _ = T.decode_step_paged(
                tp, cfg, tpool, tbl_t, torch.from_numpy(pos),
                torch.from_numpy(toks), impl=impl)
            _same_routing(routing, f"step {step} ({impl})")
            _close(tl, jl, f"step {step} logits ({impl})")
        routing["jax"].clear()
        toks[:live] = np.asarray(jnp.argmax(jl, -1))[:live]
        pos[:live] += 1
    for impl, tpool in tpools.items():
        for kk in ("k", "v"):
            _close(tpool[kk][1:], np.asarray(jpool[kk])[1:],
                   f"pool {kk} ({impl})")


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_granite_prefill_chunked_paged_matches_reference(full, jax_impl,
                                                         request, routing):
    """Chunked prefill into shuffled blocks: each chunk's MoE call has its
    own capacity (T = chunk, with the reference's token-0 pad)."""
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
    jax.effects_barrier()
    for impl in ("kernel", "plain"):
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        tl, _ = T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens)}, chunk, tpool,
            torch.from_numpy(tables), impl=impl)
        _same_routing(routing, f"chunked ({impl})")
        _close(tl, jl, f"logits ({impl})")
        for kk in ("k", "v"):
            _close(tpool[kk][tables], np.asarray(jpool[kk])[tables],
                   f"blocks {kk} ({impl})")


@pytest.mark.parametrize("full", [False, True])
def test_granite_decode_step_matches_reference(full, routing):
    """Dense decode from a JAX prefill cache, per-slot positions as
    ``test_torch_model.test_decode_step_matches_reference``."""
    jcfg, cfg = _configs(full)
    jp, tp = _params(full)
    S, C, steps = (13, 24, 3) if not full else (9, 16, 2)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, S))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                             capacity=C)
    jc = dict(jc, pos=jnp.asarray([S, 5, C + 2], jnp.int32))
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    tcaches = {impl: {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
               for impl in ("kernel", "plain")}
    jax.effects_barrier()
    routing["jax"].clear()
    for step in range(steps):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks))
        jax.effects_barrier()
        for impl, tc in tcaches.items():
            tl, tcaches[impl] = T.decode_step(tp, cfg, tc,
                                              torch.from_numpy(toks),
                                              impl=impl)
            _same_routing(routing, f"step {step} ({impl})")
            _close(tl, jl, f"step {step} logits ({impl})")
        routing["jax"].clear()
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for impl, tc in tcaches.items():
        for kk in ("k", "v"):
            _close(tc[kk], jc[kk], f"cache {kk} ({impl})")


def test_granite_full_width_prefill_drops_tokens(routing):
    """At granite's widths a 2 x 40-token prefill (T = 80, C = 25 of 640
    assignments) overflows some expert: the drops are the reference's."""
    jcfg, cfg = _configs(True)
    jp, tp = _params(True)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 40))
    JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    jax.effects_barrier()
    T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(tokens)},
                   impl="plain")
    assert _same_routing(routing, "prefill") > 0


# ---------------------------------------------------------------------------
# Serving: the reference's Cluster and Engine vs the port's


def _requests(jax_side: bool, vocab: int):
    if jax_side:
        return jmaterialize(JOpenLoopWorkload(
            JBurst(5), JFixedShape(24, 6), vocab=vocab, seed=3,
            max_requests=5, horizon_s=3600.0))
    return materialize(OpenLoopWorkload(
        Burst(5), FixedShape(24, 6), vocab=vocab, seed=3, max_requests=5,
        horizon_s=3600.0))


@pytest.mark.parametrize("paged", [True, False])
def test_granite_engines_stream_like_reference(paged):
    """Disaggregated serving of granite's smoke configuration on float32
    weights: the same greedy streams and handoff bytes as the reference's
    engines, for the paged and the dense layout."""
    jcfg, cfg = _configs(False)
    jp, tp = _params(False)
    jreqs, treqs = _requests(True, cfg.vocab_size), _requests(
        False, cfg.vocab_size)
    jeng = [JEngine(i, jcfg, jp, slots=2, capacity=40, paged=paged)
            for i in (0, 1)]
    jcl = JCluster({"prefill": jeng[:1], "decode": jeng[1:]})
    assert jcl.serve(JStaticWorkload(jreqs))["completed"] == 5
    teng = [Engine(i, cfg, tp, slots=2, capacity=40, paged=paged,
                   device="cpu") for i in (0, 1)]
    tcl = Cluster({"prefill": teng[:1], "decode": teng[1:]})
    assert tcl.serve(StaticWorkload(treqs))["completed"] == 5
    assert {r.rid: list(r.output) for r in treqs} == \
        {r.rid: list(r.output) for r in jreqs}
    assert all(len(r.output) == 6 for r in treqs)
    assert tcl.stats.transferred_bytes == jcl.stats.transferred_bytes


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def test_launcher_serves_granite_smoke_disagg_on_cpu():
    rec = _serve("--requests", "4", "--isl", "32", "--osl", "6")
    assert rec["completed"] == 4 and rec["arch"] == "granite-moe-smoke"
    assert rec["mode"] == "disagg" and rec["prefills"] == 4
    # whole blocks of 8 rows, 2 layers x K,V x 2 heads x dh 16 x bf16
    assert rec["transferred_MB"] * 2**20 == rec["transfers"] * 32 * 256


def test_launcher_serves_granite_smoke_coloc_on_cpu():
    rec = _serve("--mode", "coloc", "--requests", "4", "--isl", "32",
                 "--osl", "6", "--piggyback-chunk", "8")
    assert rec["completed"] == 4 and rec["mode"] == "coloc"
    assert rec["transfers"] == 0 and rec["prefills"] == 4
