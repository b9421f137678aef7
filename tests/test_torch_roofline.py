"""The port's roofline (``repro_torch.core.roofline``) against the JAX
package's, on the CPU.

The module is a copy of the reference's closed forms (pure arithmetic on
config fields), so on every cell, mesh and variant ``RooflineTerms`` agree
field for field with ``==``, no tolerance. The reference's own
``tests/test_roofline.py`` runs here on the port too: its two arithmetic
tests as they are, and its two HLO cross-checks against the port's own
count (``torch.utils.flop_counter.FlopCounterMode``) of ``prefill_full``
and ``train_loss`` at one layer, within the reference's bands (35% and
2x): the closed forms leave norms, RoPE and softmax uncounted.
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as rget_config
from repro.core import roofline as JR
from repro.models.config import ShapeConfig as RShape
from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.core.roofline import (MULTI_POD, SINGLE_POD, MeshDesc,
                                       Overrides, cell_roofline)
from repro_torch.launch.dryrun import VARIANTS, _overrides
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig

CPU_MESH = MeshDesc("cpu1", 1, 1, 1)
_PROPS = ("dominant", "step_s", "roofline_fraction", "flops_ratio")


def _terms(rt):
    return {**dataclasses.asdict(rt), **{p: getattr(rt, p) for p in _PROPS}}


def _ref_overrides(cfg, shape):
    """The reference dry run's inline ``Overrides`` (repro/launch/dryrun.py
    ``run_cell``), rebuilt here so the test imports no module that forces
    512 host devices."""
    from repro.core.hardware import TPU_V5E
    fsdp = cfg.param_count() * 2 / 16 > 0.45 * TPU_V5E.hbm_cap
    return JR.Overrides(
        remat=cfg.remat, moe_combine_fp32=cfg.moe_combine_fp32,
        kv_bytes_elem=(1.0 + 2.0 / cfg.dh) if cfg.kv_quant else 2.0,
        decode_grouped=bool(cfg.grouped_decode and cfg.can_group_decode),
        serve_fsdp=bool(fsdp and not cfg.moe_expert_tp
                        and shape.kind != "train"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_roofline_equals_reference_on_every_cell(arch):
    """Every runnable cell of ``arch`` on both production meshes, under
    every dry-run variant (each sets config fields the Overrides read):
    every field and property ``==`` the reference's."""
    names = [s for a, s, ok, _ in cells(include_skips=False) if a == arch]
    assert names
    n = 0
    for variant, over in VARIANTS.items():
        cfg = get_config(arch).replace(pad_heads_to=16, **over)
        rcfg = rget_config(arch).replace(pad_heads_to=16, **over)
        for name in names:
            shape = get_shape(name)
            rshape = RShape(shape.name, shape.seq_len, shape.global_batch,
                            shape.kind)
            ov, rov = _overrides(cfg, shape), _ref_overrides(rcfg, rshape)
            assert dataclasses.asdict(ov) == dataclasses.asdict(rov)
            for mesh, rmesh in ((SINGLE_POD, JR.SINGLE_POD),
                                (MULTI_POD, JR.MULTI_POD)):
                got = _terms(cell_roofline(cfg, shape, mesh, ov))
                want = _terms(JR.cell_roofline(rcfg, rshape, rmesh, rov))
                assert got == want, (arch, variant, name, mesh.name)
                n += 1
    assert n == len(VARIANTS) * len(names) * 2


def test_default_overrides_and_meshes_equal_reference():
    assert dataclasses.asdict(Overrides()) == dataclasses.asdict(
        JR.Overrides())
    for a, b in ((SINGLE_POD, JR.SINGLE_POD), (MULTI_POD, JR.MULTI_POD)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _cfg(**kw):
    base = dict(name="probe", family="dense", num_layers=1, d_model=128,
                num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                remat=False, logits_chunk=4096, dtype="float32",
                grad_accum=1)
    base.update(kw)
    return ModelConfig(**base)


def _tokens(B, S):
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 512, (B, S), generator=g)


def test_prefill_flops_closed_form_matches_port_count():
    """The reference's HLO cross-check, against the FLOPs the port's plain
    prefill runs (one layer, so nothing repeats): within 35%."""
    cfg = _cfg()
    B, S = 2, 256
    shape = ShapeConfig("p", seq_len=S, global_batch=B, kind="prefill")
    rt = cell_roofline(cfg, shape, CPU_MESH,
                       Overrides(pad_heads=False, attn_block=1024))
    params = T.init_params(cfg, seed=0, device="cpu")
    with FlopCounterMode(display=False) as fc:
        T.prefill_full(params, cfg, {"tokens": _tokens(B, S)},
                       impl="plain")
    counted = fc.get_total_flops()
    assert 0.65 < rt.hlo_flops / counted < 1.35, (rt.hlo_flops, counted)


def test_train_flops_closed_form_matches_port_count():
    """fwd + 2 x bwd closed form against the port's loss and grads: the
    reference's generous band (2x)."""
    cfg = _cfg()
    B, S = 2, 128
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    rt = cell_roofline(cfg, shape, CPU_MESH,
                       Overrides(pad_heads=False, remat=False,
                                 attn_block=1024))
    params = T.init_params(cfg, seed=0, device="cpu")
    leaves = [p.requires_grad_() for p in
              [params["embed"], params["final_norm"], params["lm_head"]]
              + [t for b in params["blocks"] for t in b.values()]]
    batch = {"tokens": _tokens(B, S), "labels": _tokens(B, S)}
    with FlopCounterMode(display=False) as fc:
        loss, _ = T.train_loss(params, cfg, batch)
        torch.autograd.grad(loss, leaves, allow_unused=True)
    counted = fc.get_total_flops()
    assert 0.5 < rt.hlo_flops / counted < 2.0, (rt.hlo_flops, counted)


def test_dominant_terms_make_sense():
    cfg = _cfg(num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
               d_ff=8192, vocab_size=32000, dtype="bfloat16")
    mesh = MeshDesc("16x16", 256, 16, 16)
    dec = cell_roofline(cfg, ShapeConfig("d", 32768, 128, "decode"), mesh)
    pre = cell_roofline(cfg, ShapeConfig("p", 32768, 32, "prefill"), mesh)
    assert dec.dominant == "memory"        # decode streams weights + KV
    assert pre.dominant == "compute"       # prefill is GEMM-bound
    assert 0 < dec.roofline_fraction < 1
    assert 0 < pre.roofline_fraction <= 1
    assert pre.flops_ratio <= 1.0          # HLO >= useful


def test_padding_charged_in_flops_ratio():
    cfg = _cfg(num_heads=5, num_kv_heads=5)   # 5 heads on a 16-wide axis
    mesh = MeshDesc("16x16", 256, 16, 16)
    shp = ShapeConfig("p", 4096, 8, "prefill")
    padded = cell_roofline(cfg.replace(pad_heads_to=16), shp, mesh)
    clean = cell_roofline(cfg, shp, mesh, Overrides(pad_heads=False))
    assert padded.hlo_flops > clean.hlo_flops
    assert padded.flops_ratio < clean.flops_ratio
