"""The port's design-space sweep (``repro_torch.core`` + ``repro_torch.sweeps``)
against the JAX package's, on the CPU.

Both sides are numpy only and do the same float64 arithmetic in the same
order (the port's modules are copies of the reference's), so on the same
inputs they give the same records, frontiers, rate-matched points, spec
hashes and reports: compared with ``==``, no tolerance. The sweep's
shards are byte-stable across hosts and platforms (the reference's own
contract), and the port's shards equal the reference's byte for byte.

Each test of the reference's ``tests/test_sweeps.py`` and
``tests/test_core.py`` runs here on the port, with its own assertions, and
compares what the port computed with the reference's on the same inputs.
Then the reference's golden grid runs through the port, a simulate grid
with worker processes against the inline run, the launcher against the
reference's, and the sweep path without an architecture id leaves torch
unloaded.
"""
import dataclasses
import json
import math
import os
import random
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import repro.core.design_space as JD
import repro.core.frontiers as JF
import repro.core.kv_transfer as JK
import repro.core.pareto as JPa
import repro.core.rate_matching as JR
import repro.launch.sweep as JLS
import repro.sweeps as JS
import repro.sweeps.simulate as JSim
import repro.sweeps.vectorized as JV
from repro.core import paper_models as JPM
from repro.core.hardware import as_system as jas_system
from repro_torch.core.design_space import sweep_decode, sweep_prefill
from repro_torch.core.frontiers import (best_hardware_frontier,
                                        colocated_frontier,
                                        default_ttl_targets,
                                        disaggregated_frontier,
                                        workload_frontier)
from repro_torch.core.hardware import (TPU_V5E, TPU_V5P, as_system, get_chip,
                                       relative_speed)
from repro_torch.core.kv_transfer import kv_transfer_requirement
from repro_torch.core.paper_models import (DEEPSEEK_R1, LLAMA31_8B,
                                           LLAMA31_70B, LLAMA31_405B,
                                           get_perf_model,
                                           perf_llm_from_config)
from repro_torch.core.pareto import (ParetoAccumulator, area_under_frontier,
                                     frontier_at, pareto_frontier)
from repro_torch.core.perf_model import (Mapping, PerfLLM, decode_step_perf,
                                         hbm_fits, kv_shard_chips,
                                         piggyback_step_perf, prefill_perf)
from repro_torch.core.rate_matching import (dynamic_rate_match,
                                            prefill_config_selection,
                                            rate_match, split_pool)
from repro_torch.launch import sweep as LS
from repro_torch.sweeps import (SweepResult, SweepSpec, SweepStore,
                                evaluate_cell, run_sweep)
from repro_torch.sweeps.simulate import simulate_cell
from repro_torch.sweeps.spec import SweepCell
from repro_torch.sweeps.vectorized import (build_grid, decode_step_perf_vec,
                                           hbm_fits_vec,
                                           piggyback_step_perf_vec,
                                           prefill_perf_vec, rate_match_vec,
                                           sweep_decode_vec,
                                           sweep_prefill_vec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "sweeps", "golden_small.json")

# the reference's heterogeneous zoo: dense GQA, MLA + MoE, linear
# attention ("none"), sliding-window — each built on both sides
_ZOO_KW = {
    "rwkv-like": dict(name="rwkv-like", num_layers=24, d_model=2048,
                      num_heads=32, num_kv_heads=32, d_ff=7168,
                      vocab_size=65536, attention="none"),
    "swa": dict(name="swa", num_layers=32, d_model=4096, num_heads=32,
                num_kv_heads=8, d_ff=14336, vocab_size=128256,
                sliding_window=1024),
}
RWKV_LIKE, SWA = (PerfLLM(**_ZOO_KW[k]) for k in ("rwkv-like", "swa"))
ZOO = [LLAMA31_8B, DEEPSEEK_R1, RWKV_LIKE, SWA]
J_ZOO = {"llama-3.1-8b": JPM.LLAMA31_8B, "deepseek-r1": JPM.DEEPSEEK_R1,
         "rwkv-like": JPM.PerfLLM(**_ZOO_KW["rwkv-like"]),
         "swa": JPM.PerfLLM(**_ZOO_KW["swa"])}
PHASE_FIELDS = ("compute_s", "memory_s", "collective_s", "latency_s",
                "step_s", "tokens")


def _jmodel(model):
    """The reference's twin of a port PerfLLM (the same fields)."""
    return J_ZOO.get(model.name) or JPM.PerfLLM(**dataclasses.asdict(model))


def _plain(x):
    """A value made comparable across the two packages: dataclasses
    (Mapping, DesignPoint, RateMatchedPoint, ...) to tuples of their
    fields, recursively."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(_plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _phase_fields(pg, i):
    return np.array([getattr(pg, f)[i] for f in PHASE_FIELDS])


def _scalar_fields(pp):
    return np.array([getattr(pp, f) for f in PHASE_FIELDS])


def _same_grid(pg, jpg):
    for f in PHASE_FIELDS:
        np.testing.assert_array_equal(getattr(pg, f), getattr(jpg, f))


# ---------------------------------------------------------------------------
# scalar <-> vectorized equivalence, and the port against the reference


@pytest.mark.parametrize("model", ZOO, ids=lambda m: m.name)
def test_decode_vec_matches_scalar(model):
    sys_ = as_system("v5p")
    g = build_grid(model, sys_, prefill=False, batches=[1, 3, 16, 100],
                   max_chips=32)
    pg = decode_step_perf_vec(model, g, kv_len=1536, sys_=sys_)
    for i in range(len(g)):
        sc = decode_step_perf(model, g.mapping(i), int(g.batch[i]), 1536,
                              sys_)
        # the reference's own vectorized-vs-scalar bound (association)
        np.testing.assert_allclose(_phase_fields(pg, i), _scalar_fields(sc),
                                   rtol=1e-9)
    jm, jsys = _jmodel(model), jas_system("v5p")
    jg = JV.build_grid(jm, jsys, prefill=False, batches=[1, 3, 16, 100],
                       max_chips=32)
    np.testing.assert_array_equal(g.chips, jg.chips)
    np.testing.assert_array_equal(g.batch, jg.batch)
    _same_grid(pg, JV.decode_step_perf_vec(jm, jg, kv_len=1536, sys_=jsys))


@pytest.mark.parametrize("model", ZOO, ids=lambda m: m.name)
def test_prefill_vec_matches_scalar(model):
    sys_ = as_system("v5p")
    g = build_grid(model, sys_, prefill=True, batches=[1, 2, 7],
                   max_chips=32)
    pg = prefill_perf_vec(model, g, isl=777, sys_=sys_)
    for i in range(len(g)):
        sc = prefill_perf(model, g.mapping(i), int(g.batch[i]), 777, sys_)
        np.testing.assert_allclose(_phase_fields(pg, i), _scalar_fields(sc),
                                   rtol=1e-9)
    jm, jsys = _jmodel(model), jas_system("v5p")
    jg = JV.build_grid(jm, jsys, prefill=True, batches=[1, 2, 7],
                       max_chips=32)
    _same_grid(pg, JV.prefill_perf_vec(jm, jg, isl=777, sys_=jsys))


@pytest.mark.parametrize("model", [LLAMA31_8B, DEEPSEEK_R1],
                         ids=lambda m: m.name)
def test_piggyback_vec_matches_scalar(model):
    sys_ = as_system("v5p")
    isl, osl = 640, 96
    g = build_grid(model, sys_, prefill=False, batches=[1, 5, 32],
                   max_chips=16)
    chunk = np.minimum(
        np.maximum(1, np.floor(g.batch * isl / osl).astype(np.int64)), isl)
    pg = piggyback_step_perf_vec(model, g, isl + osl // 2, chunk, isl // 2,
                                 sys_)
    for i in range(len(g)):
        sc = piggyback_step_perf(model, g.mapping(i), int(g.batch[i]),
                                 isl + osl // 2, int(chunk[i]), isl // 2,
                                 sys_)
        np.testing.assert_allclose(_phase_fields(pg, i), _scalar_fields(sc),
                                   rtol=1e-9)
    jm, jsys = _jmodel(model), jas_system("v5p")
    jg = JV.build_grid(jm, jsys, prefill=False, batches=[1, 5, 32],
                       max_chips=16)
    _same_grid(pg, JV.piggyback_step_perf_vec(jm, jg, isl + osl // 2, chunk,
                                              isl // 2, jsys))


def test_hbm_mask_and_sweep_order_match_scalar():
    """The vectorized sweeps keep the scalar feasibility and point order
    (mappings-major, batches-minor), and equal the reference's."""
    sys_ = as_system("v5e")
    for model in (LLAMA31_8B, SWA):
        pts = sweep_prefill(model, 1024, sys_, max_chips=32, mem_isl=2048)
        pv = sweep_prefill_vec(model, 1024, sys_, max_chips=32,
                               mem_isl=2048)
        assert len(pts) == len(pv)
        for i, p in enumerate(pts):
            assert p.mapping.chips == int(pv.grid.chips[i])
            assert p.mapping.cpp_chunks == int(pv.grid.cpp[i])
            assert p.batch == int(pv.grid.batch[i])
        jm = _jmodel(model)
        jpts = JD.sweep_prefill(jm, 1024, jas_system("v5e"), max_chips=32,
                                mem_isl=2048)
        assert _plain(pts) == _plain(jpts)
        g = build_grid(model, sys_, prefill=False, max_chips=32)
        fit = hbm_fits_vec(model, g, 4096, sys_)
        for i in range(len(g)):
            assert bool(fit[i]) == hbm_fits(model, g.mapping(i),
                                            int(g.batch[i]), 4096, sys_)
        jg = JV.build_grid(jm, jas_system("v5e"), prefill=False,
                           max_chips=32)
        np.testing.assert_array_equal(
            fit, JV.hbm_fits_vec(jm, jg, 4096, jas_system("v5e")))


def test_rate_match_vec_selections_identical():
    """Algorithms 1+2 vectorized: the scalar pipeline's winners, and the
    reference's, number for number."""
    isl, osl = 2048, 256
    for model, chips in ((LLAMA31_8B, ("v5e", "v5e")),
                         (DEEPSEEK_R1, ("v5p", "v5p")),
                         (LLAMA31_8B, ("v5p", "v5e"))):
        pre_sys, dec_sys = as_system(chips[0]), as_system(chips[1])
        pre = sweep_prefill(model, isl, pre_sys, max_chips=64, mem_isl=isl)
        dec = sweep_decode(model, isl + osl // 2, dec_sys, max_chips=64,
                           max_ctx=isl + osl)
        targets = default_ttl_targets(16)
        m_s = dynamic_rate_match(pre, dec, isl=isl, osl=osl,
                                 ftl_cutoff=10.0, ttl_targets=targets)
        pre_v = sweep_prefill_vec(model, isl, pre_sys, max_chips=64,
                                  mem_isl=isl)
        dec_v = sweep_decode_vec(model, isl + osl // 2, dec_sys,
                                 max_chips=64, max_ctx=isl + osl)
        m_v = rate_match_vec(pre_v, dec_v, osl=osl, ftl_cutoff=10.0,
                             ttl_targets=targets)
        assert len(m_s) == len(m_v) > 0
        for a, b in zip(m_s, m_v):
            assert a.alpha == b.alpha
            assert a.decode.mapping == b.decode.mapping
            assert a.decode.batch == b.decode.batch
            assert a.num_prefill_chips == b.num_prefill_chips
            assert a.num_decode_chips == b.num_decode_chips
            assert a.overall_tput_per_chip == b.overall_tput_per_chip
            assert a.tps_per_user == b.tps_per_user
        jm = _jmodel(model)
        jpre = JV.sweep_prefill_vec(jm, isl, jas_system(chips[0]),
                                    max_chips=64, mem_isl=isl)
        jdec = JV.sweep_decode_vec(jm, isl + osl // 2, jas_system(chips[1]),
                                   max_chips=64, max_ctx=isl + osl)
        j_v = JV.rate_match_vec(jpre, jdec, osl=osl, ftl_cutoff=10.0,
                                ttl_targets=JF.default_ttl_targets(16))
        assert _plain(m_v) == _plain(j_v)


def test_coloc_cell_matches_scalar_colocated_frontier():
    """The engine's vectorized coloc cell reproduces
    ``frontiers.colocated_frontier`` exactly, and its records are the
    reference's."""
    cell = SweepCell(model="llama-3.1-8b", mode="coloc",
                     prefill_chip="tpu-v5e", decode_chip="tpu-v5e",
                     isl=512, osl=64, reuse=0.0, ttl_targets=6,
                     ftl_cutoff=10.0, max_chips=16)
    records, meta = evaluate_cell(cell)
    got = sorted((r["tps_per_user"], r["tput_per_chip"]) for r in records)
    want = sorted(colocated_frontier(LLAMA31_8B, 512, 64, max_chips=16))
    assert got == want
    jcell = JS.SweepCell(**dataclasses.asdict(cell))
    assert (records, meta) == JS.evaluate_cell(jcell)


def test_default_ttl_targets_degenerate_n():
    assert default_ttl_targets(1) == [2e-3]
    assert len(default_ttl_targets(24)) == 24
    assert default_ttl_targets(24) == JF.default_ttl_targets(24)
    spec = _tiny_spec(ttl_targets=1, reuse=[0.0])
    records, meta = evaluate_cell(spec.cells()[0])
    assert meta["points"] > 0 and len(records) <= 1


def test_frontier_engine_bridge():
    """disaggregated_frontier(engine='vectorized') is the same frontier,
    and the reference's."""
    kw = dict(max_chips=32, ttl_targets=default_ttl_targets(12),
              reuse_fraction=0.25, hardware={"prefill": "v5p",
                                             "decode": "v5e"})
    f_s = disaggregated_frontier(LLAMA31_8B, 1024, 128, **kw)
    f_v = disaggregated_frontier(LLAMA31_8B, 1024, 128, engine="vectorized",
                                 **kw)
    assert f_s == f_v
    assert f_s == JF.disaggregated_frontier(JPM.LLAMA31_8B, 1024, 128, **kw)


# ---------------------------------------------------------------------------
# cost-weighted objective


def test_cost_weighted_frontier_uses_dollars():
    v5e, v5p = get_chip("v5e"), get_chip("v5p")
    kw = dict(max_chips=16, ttl_targets=default_ttl_targets(8))
    per_chip = best_hardware_frontier(LLAMA31_8B, 512, 64, ["v5e", "v5p"],
                                      **kw)
    per_dollar = best_hardware_frontier(LLAMA31_8B, 512, 64,
                                        ["v5e", "v5p"], weight="cost", **kw)
    assert per_chip and per_dollar
    lo, hi = min(v5e.cost_per_hour, v5p.cost_per_hour), \
        max(v5e.cost_per_hour, v5p.cost_per_hour)
    a_chip = area_under_frontier(per_chip, 10, 300)
    a_cost = area_under_frontier(per_dollar, 10, 300)
    assert a_chip / hi <= a_cost <= a_chip / lo * 1.5
    assert per_dollar == JF.best_hardware_frontier(
        JPM.LLAMA31_8B, 512, 64, ["v5e", "v5p"], weight="cost", **kw)


def test_rate_matched_point_cost_properties():
    matched = dynamic_rate_match(
        model=LLAMA31_8B, prefill_sys="v5p", decode_sys="v5e",
        isl=512, osl=64, ftl_cutoff=10.0,
        ttl_targets=default_ttl_targets(6), max_chips=16)
    assert matched
    r = matched[0]
    v5e, v5p = get_chip("v5e"), get_chip("v5p")
    expect = (r.num_prefill_chips * v5p.cost_per_hour
              + r.num_decode_chips * v5e.cost_per_hour)
    assert r.cost_per_hour == expect
    assert r.overall_tput_per_dollar == pytest.approx(
        r.overall_tput_per_chip * r.total_chips / expect)
    jr = JR.dynamic_rate_match(
        model=JPM.LLAMA31_8B, prefill_sys="v5p", decode_sys="v5e",
        isl=512, osl=64, ftl_cutoff=10.0,
        ttl_targets=JF.default_ttl_targets(6), max_chips=16)[0]
    assert (r.cost_per_hour, r.overall_tput_per_dollar) == \
        (jr.cost_per_hour, jr.overall_tput_per_dollar)


# ---------------------------------------------------------------------------
# pareto determinism + streaming accumulator


def test_pareto_frontier_order_and_duplicate_invariant():
    pts = [(1.0, 5.0), (1.0, 7.0), (2.0, 7.0), (2.0, 7.0), (3.0, 2.0),
           (0.5, 7.0), (3.0, 2.0 - 1e-18)]
    f = pareto_frontier(pts)
    for seed in range(20):
        shuffled = pts[:]
        random.Random(seed).shuffle(shuffled)
        assert pareto_frontier(shuffled) == f
    assert (2.0, 7.0) in f and (1.0, 7.0) not in f and (0.5, 7.0) not in f
    xs = [x for x, _ in f]
    ys = [y for _, y in f]
    assert xs == sorted(xs) and len(set(xs)) == len(xs)
    assert ys == sorted(ys, reverse=True) and len(set(ys)) == len(ys)
    assert f == JPa.pareto_frontier(pts)


def test_pareto_accumulator_streaming_merge_exact():
    rng = random.Random(7)
    pts = [(rng.uniform(1, 300), rng.uniform(1, 100)) for _ in range(5000)]
    acc = ParetoAccumulator(compact_at=64)
    jacc = JPa.ParetoAccumulator(compact_at=64)
    for i in range(0, len(pts), 137):     # ragged out-of-order shards
        acc.add(pts[i:i + 137])
        jacc.add(pts[i:i + 137])
    assert acc.frontier() == pareto_frontier(pts) == jacc.frontier()
    assert acc.n_seen == len(pts) == jacc.n_seen
    assert acc.area(10, 300) == area_under_frontier(pareto_frontier(pts),
                                                    10, 300)
    assert acc.area(10, 300) == jacc.area(10, 300)
    f = acc.frontier()
    for x in (0.5, 10.0, 77.7, 299.0, 400.0):
        assert frontier_at(f, x) == JPa.frontier_at(f, x)


# ---------------------------------------------------------------------------
# spec + store + engine


def _tiny_spec(**over):
    kw = dict(models=["llama-3.1-8b"], hardware=["v5e", "v5p:v5e"],
              isl=[512], osl=[64], reuse=[0.0, 0.5],
              modes=["disagg"], ttl_targets=6, max_chips=16)
    kw.update(over)
    return SweepSpec.create(**kw)


def _jspec(spec):
    """The reference's spec of the same grid."""
    return JS.SweepSpec.from_dict(spec.canonical())


def test_spec_hash_is_order_insensitive_and_canonical():
    a = SweepSpec.create(models=["llama-3.1-8b", "deepseek-r1"],
                         hardware=["v5p:v5e", "v5e"], isl=[2048, 512],
                         osl=[64], reuse=[0.5, 0.0])
    b = SweepSpec.create(models=["deepseek-r1", "llama-3.1-8b"],
                         hardware=[("tpu-v5p", "tpu-v5e"), "tpu-v5e"],
                         isl=[512, 2048], osl=[64], reuse=[0.0, 0.5])
    assert a.spec_hash() == b.spec_hash()
    assert SweepSpec.from_dict(a.canonical()).spec_hash() == a.spec_hash()
    c = SweepSpec.from_dict(dict(a.canonical(), osl=[128]))
    assert c.spec_hash() != a.spec_hash()
    for s in (a, c, _tiny_spec(simulate=True)):
        assert s.spec_hash() == _jspec(s).spec_hash()
        assert s.to_json() == _jspec(s).to_json()
        assert [x.cell_id() for x in s.cells()] == \
            [x.cell_id() for x in _jspec(s).cells()]


def test_spec_expand_dedupes_coloc_hetero_pairs():
    spec = _tiny_spec(modes=["coloc"], hardware=["v5e", "v5p:v5e", "v5p"])
    cells = spec.cells()
    assert {(c.prefill_chip, c.decode_chip) for c in cells} == {
        ("tpu-v5e", "tpu-v5e"), ("tpu-v5p", "tpu-v5p")}
    assert all(c.reuse == 0.0 for c in cells)
    assert len(cells) == 2
    assert [dataclasses.asdict(c) for c in cells] == \
        [dataclasses.asdict(c) for c in _jspec(spec).cells()]


def test_store_roundtrip_and_resume(tmp_path):
    spec = _tiny_spec()
    store = SweepStore(str(tmp_path / "s"))
    cells = spec.cells()
    assert store.pending(spec) == cells
    records, meta = evaluate_cell(cells[0])
    store.write_shard(spec, cells[0], records, meta)
    assert store.completed(spec, cells[0])
    got, got_meta = store.read_shard(spec, cells[0])
    assert got == records
    assert got_meta["points"] == meta["points"]
    assert store.pending(spec) == cells[1:]
    shard_dir = os.path.dirname(store.shard_path(spec, cells[0]))
    assert all(f.endswith(".jsonl") for f in os.listdir(shard_dir))
    # the reference reads the port's shard as its own
    jstore = JS.SweepStore(str(tmp_path / "s"))
    jspec = _jspec(spec)
    assert jstore.read_shard(jspec, jspec.cells()[0]) == (got, got_meta)


def test_run_sweep_resume_from_partial_store_matches_one_shot(tmp_path):
    spec = _tiny_spec()
    one = SweepStore(str(tmp_path / "one"))
    r_full = run_sweep(spec, one)
    assert r_full.cells_run == r_full.cells_total > 0

    two = SweepStore(str(tmp_path / "two"))
    r1 = run_sweep(spec, two, limit=2)
    assert r1.cells_run == 2
    r2 = run_sweep(spec, two)
    assert r2.cells_cached == 2
    assert r2.cells_run == r_full.cells_total - 2
    assert (SweepResult(two, spec).records()
            == SweepResult(one, spec).records())
    r3 = run_sweep(spec, two)
    assert r3.cells_run == 0 and r3.cells_cached == r_full.cells_total
    assert r3.points == r_full.points
    assert r3.frontier_areas == r_full.frontier_areas
    j = JS.run_sweep(_jspec(spec), JS.SweepStore(str(tmp_path / "ref")))
    assert _report(r_full) == _report(j)


def _report(r):
    """A SweepReport without its wall-clock fields."""
    d = r.to_json() if hasattr(r, "to_json") else dict(r)
    return {k: v for k, v in d.items()
            if k not in ("elapsed_s", "points_per_s")}


def test_rewrite_refreshes_spec_dir_shard(tmp_path):
    spec = _tiny_spec()
    store = SweepStore(str(tmp_path / "s"))
    cell = spec.cells()[0]
    store.register(spec)
    store.write_shard(spec, cell, [{"v": 1}], {"points": 1})
    store.write_shard(spec, cell, [{"v": 2}], {"points": 1})
    records, _ = store.read_shard(spec, cell)
    assert records == [{"v": 2}]
    store2 = SweepStore(str(tmp_path / "s2"))
    run_sweep(spec, store2)
    before = SweepResult(store2, spec).records()
    r = run_sweep(spec, store2, resume=False)
    assert r.cells_run == r.cells_total
    assert SweepResult(store2, spec).records() == before


def test_workload_frontier_coloc_cost_weight():
    from repro.workloads import WorkloadSummary as JWorkloadSummary
    from repro_torch.workloads import WorkloadSummary
    wl = WorkloadSummary(isl=512, osl=64)
    kw = dict(mode="coloc", max_chips=8)
    f_chip = workload_frontier(LLAMA31_8B, wl, **kw)
    f_cost = workload_frontier(LLAMA31_8B, wl, weight="cost", **kw)
    assert f_chip and len(f_chip) == len(f_cost)
    price = get_chip("v5e").cost_per_hour
    for (x1, y1), (x2, y2) in zip(f_chip, f_cost):
        assert x1 == x2 and y2 == pytest.approx(y1 / price)
    with pytest.raises(ValueError):
        workload_frontier(LLAMA31_8B, wl, weight="nope", **kw)
    assert f_cost == JF.workload_frontier(
        JPM.LLAMA31_8B, JWorkloadSummary(isl=512, osl=64), weight="cost",
        **kw)


def test_overlapping_specs_share_cells(tmp_path):
    store = SweepStore(str(tmp_path / "s"))
    small = _tiny_spec(reuse=[0.0])
    run_sweep(small, store)
    superset = _tiny_spec(reuse=[0.0, 0.5])
    assert superset.spec_hash() != small.spec_hash()
    r = run_sweep(superset, store)
    assert r.cells_cached == small.n_cells()
    assert r.cells_run == superset.n_cells() - small.n_cells()


def test_sweep_result_queries(tmp_path):
    spec = _tiny_spec(hardware=["v5e", "v5p", "v5p:v5e"])
    store = SweepStore(str(tmp_path / "s"))
    run_sweep(spec, store)
    res = SweepResult(store, spec)
    recs = res.records()
    assert recs and all(r["model"] == "llama-3.1-8b" for r in recs)
    f = res.frontier(mode="disagg")
    assert f == pareto_frontier([(r["tps_per_user"], r["tput_per_chip"])
                                 for r in recs])
    ranked = res.best_hardware(mode="disagg")
    assert len(ranked) == 3
    assert ranked[0][1] >= ranked[-1][1]
    sens = res.sensitivity("reuse", mode="disagg")
    assert [v for v, _ in sens] == [0.0, 0.5]
    assert sens[1][1] >= sens[0][1] - 1e-9
    pinned = res.best_hardware(mode="disagg", prefill_chip="tpu-v5p")
    assert {p for (p, _), _ in pinned} == {"tpu-v5p"}
    assert res.sensitivity("isl", mode="disagg", isl=512) == \
        res.sensitivity("isl", mode="disagg")
    with pytest.raises(KeyError):
        res.records(nope=1)
    with pytest.raises(KeyError):
        res.sensitivity("nope")
    # the reference's queries over the same store give the same answers
    jres = JS.SweepResult(JS.SweepStore(str(tmp_path / "s")), _jspec(spec))
    assert jres.records() == recs
    assert jres.frontier(mode="disagg", weight="cost") == \
        res.frontier(mode="disagg", weight="cost")
    assert jres.best_hardware(mode="disagg") == ranked
    assert jres.sensitivity("reuse", mode="disagg") == sens
    assert jres.summary() == res.summary()


def test_arch_ids_resolve_in_sweeps():
    m = get_perf_model("qwen2.5-3b")
    assert m.num_layers > 0
    with pytest.raises(KeyError):
        get_perf_model("not-a-model")
    for arch in ("qwen2.5-3b", "qwen3-14b", "phi3-medium-14b",
                 "rwkv6-1.6b", "llama-3.1-8b"):
        assert dataclasses.asdict(get_perf_model(arch)) == \
            dataclasses.asdict(JPM.get_perf_model(arch)), arch


# ---------------------------------------------------------------------------
# simulator-in-the-loop axis (the port's SimEngine episodes)


def test_simulate_axis_hash_compat_and_distinct():
    plain, simmed = _tiny_spec(), _tiny_spec(simulate=True)
    assert "simulate" not in plain.canonical()
    assert "simulate" not in plain.cells()[0].canonical()
    assert simmed.canonical()["simulate"] is True
    assert plain.spec_hash() != simmed.spec_hash()
    assert plain.cells()[0].cell_id() != simmed.cells()[0].cell_id()
    assert SweepSpec.from_dict(simmed.canonical()) == simmed
    assert _tiny_spec(simulate=True, sim_requests=8).spec_hash() \
        != simmed.spec_hash()
    assert simmed.cells()[0].cell_id() == _jspec(simmed).cells()[0].cell_id()


def test_simulate_cell_records_sla_columns_deterministically():
    cell = _tiny_spec(simulate=True, sim_requests=8).cells()[0]
    assert cell.simulate and cell.sim_requests == 8
    recs = simulate_cell(cell)
    assert len(recs) == 1
    r = recs[0]
    assert r["kind"] == "sim"
    assert r["completed"] == 8
    assert r["tput_per_chip"] > 0 and r["tput_per_dollar"] > 0
    assert r["p50_ftl_s"] > 0 and r["p50_ttl_s"] > 0
    assert r["tps_per_user"] == pytest.approx(1.0 / r["p50_ttl_s"])
    assert simulate_cell(cell) == recs
    # the port's SimEngine + Cluster run the reference's episode
    assert recs == JSim.simulate_cell(JS.SweepCell(**dataclasses.asdict(
        cell)))


def _cells_by_reuse(spec):
    return {c.reuse: c for c in spec.cells()
            if (c.prefill_chip, c.decode_chip) == ("tpu-v5e", "tpu-v5e")}


def test_simulate_cell_reuse_hits_prefix_cache_and_speeds_prefill():
    cells = _cells_by_reuse(_tiny_spec(simulate=True, sim_requests=8,
                                       reuse=[0.0, 0.5]))
    cold = simulate_cell(cells[0.0])[0]
    warm = simulate_cell(cells[0.5])[0]
    assert cold["cache_hit_tokens"] == 0 and cold["reuse_via"] == "none"
    assert warm["cache_hit_tokens"] > 0
    assert warm["reuse_via"] == "prefix_cache"
    assert warm["p50_ftl_s"] < cold["p50_ftl_s"]
    assert [warm] == JSim.simulate_cell(JS.SweepCell(**dataclasses.asdict(
        cells[0.5])))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen3-14b",
                                  "phi3-medium-14b", "granite-moe-1b-a400m"])
def test_simulate_cell_arch_ids_match_reference(arch):
    """Architecture ids resolve through each package's own registry; the
    episodes agree, the cache-less family's reuse through the shorter
    prompt (the reference's effective-ISL contract), the attention
    family's through the prefix cache."""
    cells = _cells_by_reuse(_tiny_spec(models=[arch], simulate=True,
                                       sim_requests=6, reuse=[0.0, 0.5]))
    cold = simulate_cell(cells[0.0])[0]
    warm = simulate_cell(cells[0.5])[0]
    assert warm["reuse_via"] == ("effective_isl" if arch == "rwkv6-1.6b"
                                 else "prefix_cache")
    assert warm["p50_ftl_s"] < cold["p50_ftl_s"]
    for c, r in ((cells[0.0], cold), (cells[0.5], warm)):
        assert [r] == JSim.simulate_cell(JS.SweepCell(**dataclasses.asdict(
            c)))


def test_simulate_cell_cacheless_family_gets_effective_isl_discount():
    cells = _cells_by_reuse(_tiny_spec(models=["rwkv6-1.6b"], simulate=True,
                                       sim_requests=6, reuse=[0.0, 0.5]))
    cold = simulate_cell(cells[0.0])[0]
    warm = simulate_cell(cells[0.5])[0]
    assert warm["reuse_via"] == "effective_isl"
    assert warm["cache_hit_tokens"] == 0
    assert warm["p50_ftl_s"] < cold["p50_ftl_s"]


def test_simulate_sweep_cache_hit_and_result_views(tmp_path):
    spec = _tiny_spec(simulate=True, sim_requests=8,
                      modes=["disagg", "coloc"])
    store = SweepStore(str(tmp_path / "s"))
    r1 = run_sweep(spec, store)
    assert r1.cells_run == r1.cells_total > 0
    assert any(k.endswith("/sim") for k in r1.frontier_areas)
    r2 = run_sweep(spec, store)
    assert r2.cells_run == 0 and r2.cells_cached == r1.cells_total
    assert r2.frontier_areas == r1.frontier_areas

    res = SweepResult(store, spec)
    sims = res.sim_records()
    assert len(sims) == r1.cells_total
    assert all(r["kind"] == "sim" for r in sims)
    assert len(res.records()) == len(sims) + len(res.records(
        kind="analytic"))
    assert res.frontier(mode="disagg") == res.frontier(
        mode="disagg", kind="analytic")
    assert res.sim_frontier(mode="disagg")
    assert res.sim_records(kind="analytic") == sims
    assert res.sim_frontier(kind="sim") == res.sim_frontier()
    deltas = res.sim_delta(mode="disagg")
    assert len(deltas) == len(res.sim_records(mode="disagg"))
    for d in deltas:
        assert d["analytic_tput_per_chip"] > 0
        assert 0 < d["ratio"] < 1.0
    assert res.summary()["sim_records"] == len(sims)
    jres = JS.SweepResult(JS.SweepStore(str(tmp_path / "s")), _jspec(spec))
    assert jres.sim_delta(mode="disagg") == deltas
    assert jres.sim_frontier(mode="coloc") == res.sim_frontier(mode="coloc")
    j1 = JS.run_sweep(_jspec(spec), JS.SweepStore(str(tmp_path / "ref")))
    assert _report(r1) == _report(j1)


def test_simulate_sweep_parquet_roundtrip_keeps_kind_absence(tmp_path):
    store = SweepStore(str(tmp_path / "p"), fmt="parquet")
    if store.fmt != "parquet":
        pytest.skip("pyarrow not available")
    spec = _tiny_spec(simulate=True, sim_requests=8, reuse=[0.0])
    run_sweep(spec, store)
    res = SweepResult(store, spec)
    analytic = res.records(kind="analytic")
    assert analytic and all("kind" not in r for r in analytic)
    assert res.frontier()
    for d in res.sim_delta():
        assert d["analytic_tput_per_chip"] > 0 and 0 < d["ratio"] < 1.0
    jres = JS.SweepResult(JS.SweepStore(str(tmp_path / "p"),
                                        fmt="parquet"), _jspec(spec))
    assert jres.records() == res.records()


# ---------------------------------------------------------------------------
# golden: the reference's end-to-end frontier records, through the port


def test_golden_small_grid():
    """The reference's golden grid (``tests/data/sweeps/golden_small.json``,
    read only) through the port: the same hash, points and records, equal
    with ``==`` (the sweep is byte-stable across platforms), and equal to
    the reference's own run of the grid."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    spec = SweepSpec.from_dict(golden["spec"])
    assert spec.spec_hash() == golden["spec_hash"]
    with tempfile.TemporaryDirectory() as root:
        report = run_sweep(spec, SweepStore(root))
        records = SweepResult(SweepStore(root), spec).records()
    assert report.points == golden["points"]
    assert records == golden["records"]
    with tempfile.TemporaryDirectory() as root:
        jreport = JS.run_sweep(_jspec(spec), JS.SweepStore(root))
    assert _report(report) == _report(jreport)


# ---------------------------------------------------------------------------
# byte stability, workers, the launcher, import hygiene


_SWEEP_ONCE = """
import sys
from {pkg}.sweeps import SweepSpec, SweepStore, run_sweep

spec = SweepSpec.create(models=["llama-3.1-8b", "qwen3-14b"],
                        hardware=["v5e", "h100:a100"], isl=[128], osl=[16],
                        reuse=[0.0, 0.5], modes=["disagg", "coloc"],
                        ttl_targets=3, max_chips=8, simulate=True,
                        sim_requests=4)
run_sweep(spec, SweepStore(sys.argv[1]), workers=int(sys.argv[2]))
"""


def _shard_tree(root):
    tree = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                tree[os.path.relpath(p, root)] = f.read()
    return tree


def _sweep_in_subprocess(pkg, out, hashseed, workers=0):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONHASHSEED=hashseed)
    proc = subprocess.run(
        [sys.executable, "-c", _SWEEP_ONCE.format(pkg=pkg), str(out),
         str(workers)], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    tree = _shard_tree(out)
    assert tree, "sweep wrote no shards"
    return tree


def test_sweep_shards_byte_stable_across_hash_seeds(tmp_path):
    """The same ``simulate=True`` sweep (a paper model and an architecture
    id, both modes) in fresh interpreters with different
    ``PYTHONHASHSEED``s writes byte-identical shard trees — and the
    reference's interpreter writes the same bytes."""
    a = _sweep_in_subprocess("repro_torch", tmp_path / "a", "0")
    b = _sweep_in_subprocess("repro_torch", tmp_path / "b", "1")
    ref = _sweep_in_subprocess("repro", tmp_path / "ref", "0")
    assert sorted(a) == sorted(b) == sorted(ref)
    for rel in sorted(a):
        assert a[rel] == b[rel] == ref[rel], f"shard bytes differ: {rel}"


def test_simulate_sweep_with_workers_matches_inline(tmp_path):
    """Two worker processes (forked from a fresh interpreter that imports
    no torch) write the inline run's shards byte for byte."""
    inline = _sweep_in_subprocess("repro_torch", tmp_path / "inline", "0")
    pooled = _sweep_in_subprocess("repro_torch", tmp_path / "pool", "0",
                                  workers=2)
    assert sorted(inline) == sorted(pooled)
    for rel in sorted(inline):
        assert inline[rel] == pooled[rel], rel


def test_launcher_matches_reference(tmp_path, capsys):
    """``python -m repro_torch.launch.sweep`` takes the reference's flags
    and prints the reference's report (its wall-clock fields aside), then
    the same query answers."""
    args = ["--models", "llama-3.1-8b", "phi3-medium-14b", "--hardware",
            "h100", "h100:a100", "--isl", "512", "--osl", "64", "--reuse",
            "0.0", "0.5", "--modes", "disagg", "coloc", "--max-chips", "16",
            "--ttl-targets", "6", "--simulate", "--sim-requests", "4",
            "--quiet"]
    rep = LS.main(args + ["--store", str(tmp_path / "p")])
    jrep = JLS.main(args + ["--store", str(tmp_path / "j")])
    assert _report(rep) == _report(jrep)
    assert rep.cells_total == rep.cells_run > 0
    for query in (["--query", "best-hardware", "--weight", "cost"],
                  ["--query", "sensitivity", "--axis", "reuse"],
                  ["--query", "sim-delta"], ["--query", "frontier"]):
        capsys.readouterr()
        out = LS.main(args + ["--store", str(tmp_path / "p")] + query)
        jout = JLS.main(args + ["--store", str(tmp_path / "j")] + query)
        assert json.loads(json.dumps(out)) == json.loads(json.dumps(jout))


def test_launcher_granite_matches_reference(tmp_path):
    """``--models granite-moe-1b-a400m``: the MoE architecture id resolves
    through each package's registry (the perf model prices its 32 experts,
    top-8), and the port's report and records equal the reference's."""
    args = ["--models", "granite-moe-1b-a400m", "--hardware", "h100",
            "h100:a100", "--isl", "512", "2048", "--osl", "64", "--reuse",
            "0.0", "0.5", "--modes", "disagg", "coloc", "--max-chips", "16",
            "--ttl-targets", "6", "--simulate", "--sim-requests", "4",
            "--quiet"]
    rep = LS.main(args + ["--store", str(tmp_path / "p")])
    jrep = JLS.main(args + ["--store", str(tmp_path / "j")])
    assert _report(rep) == _report(jrep)
    assert rep.cells_total == rep.cells_run > 0 and rep.records > 0
    mine, ref = _shard_tree(tmp_path / "p"), _shard_tree(tmp_path / "j")
    assert mine and sorted(mine) == sorted(ref)
    for rel in sorted(mine):
        assert mine[rel] == ref[rel], f"shard bytes differ: {rel}"


def test_motivation_grid_hash_and_cells():
    """The design grid of ``chip_smoke.py``'s sweep phase: five models x
    three hardware pairs x 3 ISL x 2 OSL x 2 reuse x both modes, with the
    simulate axis — its content address and cell count on both sides
    (the card run checks its 695,418 points)."""
    kw = dict(models=["llama-3.1-8b", "qwen3-14b", "phi3-medium-14b",
                      "qwen2.5-3b", "rwkv6-1.6b"],
              hardware=["h100", "a100", "h100:a100"], isl=[512, 2048, 8192],
              osl=[64, 256], reuse=[0.0, 0.5], modes=["disagg", "coloc"],
              max_chips=64, simulate=True)
    spec = SweepSpec.create(**kw)
    assert spec.spec_hash() == JS.SweepSpec.create(**kw).spec_hash() \
        == "4944b71631008786"
    assert spec.n_cells() == 240


def test_sweep_path_leaves_torch_unloaded():
    """With paper models only, the sweep (the simulate axis included)
    imports neither torch nor the JAX package: architecture ids are what
    pull torch in, through the registry, as jax in the reference."""
    code = (
        "import sys, tempfile\n"
        "from repro_torch.sweeps import SweepSpec, SweepStore, run_sweep\n"
        "spec = SweepSpec.create(models=['llama-3.1-8b'], hardware=['h100'],"
        " isl=[128], osl=[16], modes=['disagg', 'coloc'], ttl_targets=3,"
        " max_chips=8, simulate=True, sim_requests=4)\n"
        "r = run_sweep(spec, SweepStore(tempfile.mkdtemp()))\n"
        "assert r.cells_run == 2, r\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.core.paper_models import get_perf_model\n"
        "get_perf_model('qwen3-14b')\n"
        "assert 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr


SLICE_MODULES = ("core/pareto.py", "core/design_space.py",
                 "core/rate_matching.py", "core/frontiers.py",
                 "core/kv_transfer.py", "sweeps/spec.py", "sweeps/store.py",
                 "sweeps/vectorized.py", "sweeps/engine.py",
                 "sweeps/result.py", "sweeps/simulate.py",
                 "sweeps/__init__.py", "launch/sweep.py",
                 "configs/qwen3_14b.py", "configs/phi3_medium_14b.py")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_is_the_references_copy(module):
    """Each module of this slice sits at the reference's path, imports
    neither jax nor the JAX package (the walk of
    ``tests/test_torch_launch.py`` covers it too), and defines the
    reference's public names."""
    import ast
    port = os.path.join(ROOT, "src", "repro_torch", module)
    ref = os.path.join(ROOT, "src", "repro", module)

    def tree(path):
        with open(path) as f:
            return ast.parse(f.read())

    imported = set()
    for node in ast.walk(tree(port)):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module or "")
    assert not {m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "repro")}, imported

    def names(path):
        return {n.name for n in tree(path).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))} | {
            t.id for n in tree(path).body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)}

    assert names(port) == names(ref)


def test_policies_take_split_pool_from_rate_matching():
    """The port's policies have no copy of ``split_pool``: the static rate
    matcher sizes pools with ``core.rate_matching``'s, as the reference's
    does; the function gives the reference's splits."""
    from repro_torch.serving import policies
    assert policies.split_pool is split_pool
    assert "def split_pool" not in open(policies.__file__).read()
    for n in (2, 3, 7, 16):
        for alpha in (0.1, 0.5, 1.0, 3.0):
            assert split_pool(n, alpha) == JR.split_pool(n, alpha)


# ---------------------------------------------------------------------------
# the core paper library (the reference's tests/test_core.py on the port)


def test_param_counts_match_public_models():
    assert abs(DEEPSEEK_R1.params() / 1e9 - 671) < 50
    assert abs(DEEPSEEK_R1.active_params() / 1e9 - 37) < 5
    assert abs(LLAMA31_70B.params() / 1e9 - 70) < 3
    assert abs(LLAMA31_405B.params() / 1e9 - 405) < 15
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    # the port's registry (no kimi-k2 there): the two 14B dense models,
    # by their configs' counts (untied heads)
    for arch, billions in (("qwen3-14b", 14.8), ("phi3-medium-14b", 14.7)):
        m = perf_llm_from_config(get_config(arch))
        assert abs(m.params() / 1e9 - billions) < 0.3, (arch, m.params())
        assert dataclasses.asdict(m) == dataclasses.asdict(
            JPM.perf_llm_from_config(jget_config(arch)))


def test_mla_kv_much_smaller_than_gqa():
    assert DEEPSEEK_R1.kv_bytes_per_token() < LLAMA31_8B.kv_bytes_per_token()


def test_decode_is_memory_bound_prefill_is_compute_bound():
    m = Mapping(chips=8, tp=8)
    d = decode_step_perf(LLAMA31_70B, m, batch=8, kv_len=8192)
    p = prefill_perf(LLAMA31_70B, m, batch=1, isl=8192)
    assert d.bound == "memory"
    assert p.bound == "compute"


def test_prefill_latency_scales_superlinearly_with_isl():
    m = Mapping(chips=16, tp=16)
    t1 = prefill_perf(LLAMA31_70B, m, 1, 8192).latency_s
    t2 = prefill_perf(LLAMA31_70B, m, 1, 32768).latency_s
    assert t2 > 4.0 * t1


def test_cpp_reduces_ftl_at_same_chips():
    plain = prefill_perf(DEEPSEEK_R1,
                         Mapping(chips=64, tp=1, pp=1, dp_attn=64),
                         1, 262144)
    ftls = [plain.latency_s]
    for pp in (2, 4, 8):
        cpp = prefill_perf(
            DEEPSEEK_R1,
            Mapping(chips=64, tp=1, pp=pp, dp_attn=64 // pp, cpp_chunks=16),
            1, 262144)
        ftls.append(cpp.latency_s)
    assert all(b < a for a, b in zip(ftls, ftls[1:])), ftls


def test_hbm_capacity_constraint():
    assert not hbm_fits(LLAMA31_70B, Mapping(chips=1, tp=1), batch=1,
                        max_ctx=8192)
    assert hbm_fits(LLAMA31_70B, Mapping(chips=32, tp=32), batch=1,
                    max_ctx=8192)


def test_kv_duplication_rule():
    assert kv_shard_chips(LLAMA31_70B, Mapping(chips=64, tp=64)) == 8
    assert kv_shard_chips(DEEPSEEK_R1, Mapping(chips=8, tp=8)) == 1


def test_algorithm1_picks_best_under_cutoff():
    pts = sweep_prefill(LLAMA31_8B, 8192, max_chips=16)
    best = prefill_config_selection(pts, ftl_cutoff=10.0)
    assert best is not None
    tput = best.batch / (best.perf.latency_s * best.mapping.chips)
    for p in pts:
        if p.perf.latency_s < 10.0:
            assert tput >= p.batch / (p.perf.latency_s * p.mapping.chips) \
                - 1e-9
    jpts = JD.sweep_prefill(JPM.LLAMA31_8B, 8192, max_chips=16)
    assert _plain(best) == _plain(JR.prefill_config_selection(jpts, 10.0))


def test_rate_match_balances_pools():
    pre = sweep_prefill(LLAMA31_8B, 8192, max_chips=16)
    dec = sweep_decode(LLAMA31_8B, 8448, max_chips=16)
    best = prefill_config_selection(pre, 10.0)
    matched = rate_match(best, dec, osl=512, tolerance=0.02,
                         max_denominator=512)
    assert matched
    for r in matched:
        pre_rate = (best.batch / (best.perf.latency_s * best.mapping.chips)
                    ) * r.num_prefill_chips
        dec_rate = (r.decode.batch / (r.decode.perf.latency_s
                                      * r.decode.mapping.chips)
                    / 511) * r.num_decode_chips
        imbalance = min(pre_rate, dec_rate) / max(pre_rate, dec_rate)
        at_boundary = (r.alpha.denominator >= 512 or r.alpha.numerator >= 512
                       or r.alpha.numerator == 1 and r.alpha.denominator > 64)
        if not at_boundary:
            assert imbalance > 0.9, (imbalance, r.alpha)
        assert r.num_prefill_chips % best.mapping.chips == 0
        assert r.num_decode_chips % r.decode.mapping.chips == 0
    jpre = JD.sweep_prefill(JPM.LLAMA31_8B, 8192, max_chips=16)
    jdec = JD.sweep_decode(JPM.LLAMA31_8B, 8448, max_chips=16)
    jmatched = JR.rate_match(JR.prefill_config_selection(jpre, 10.0), jdec,
                             osl=512, tolerance=0.02, max_denominator=512)
    assert _plain(matched) == _plain(jmatched)


def test_eq1_eq2_bandwidth_formulas():
    m = LLAMA31_70B
    pre_map = Mapping(chips=8, tp=8)
    dec_map = Mapping(chips=16, tp=16)
    isl, osl, ftl, ttl = 8192, 512, 2.0, 0.01
    r = kv_transfer_requirement(m, isl=isl, osl=osl, ftl=ftl, ttl=ttl,
                                prefill_mapping=pre_map,
                                decode_mapping=dec_map,
                                prefill_batch=4, decode_batch=32)
    kv_req = m.num_layers * 2 * m.num_kv_heads * m.dh * 2 * isl
    egress = kv_req * 4 / (ftl * 8)
    ingress = kv_req * 32 / (ttl * osl * 8)
    assert math.isclose(r.egress_bw, egress, rel_tol=1e-9)
    assert math.isclose(r.ingress_bw, ingress, rel_tol=1e-9)
    from repro.core.perf_model import Mapping as JMapping
    jr = JK.kv_transfer_requirement(
        JPM.LLAMA31_70B, isl=isl, osl=osl, ftl=ftl, ttl=ttl,
        prefill_mapping=JMapping(chips=8, tp=8),
        decode_mapping=JMapping(chips=16, tp=16), prefill_batch=4,
        decode_batch=32)
    assert _plain(r) == _plain(jr)


def test_pareto_frontier_properties():
    pts = [(1, 5), (2, 4), (2, 6), (3, 1), (0.5, 5.5)]
    f = pareto_frontier(pts)
    xs = [x for x, _ in f]
    ys = [y for _, y in f]
    assert xs == sorted(xs)
    assert ys == sorted(ys, reverse=True)
    assert (2, 6) in f and (3, 1) in f and (2, 4) not in f


def test_as_system_coercion():
    assert as_system("v5p").chip.name == "tpu-v5p"
    assert as_system(TPU_V5E).chip is TPU_V5E
    sys_ = as_system("v5e")
    assert as_system(sys_) is sys_
    assert get_chip("v5p") is TPU_V5P
    assert relative_speed(TPU_V5E) == pytest.approx(1.0)
    assert relative_speed(TPU_V5P) > 2.0
    assert as_system("h100").chip.name == "gpu-h100"
    assert get_chip("a100").hbm_cap == 80 * 2**30
    assert get_chip("h100").cost_per_hour > get_chip("v5e").cost_per_hour
    with pytest.raises(KeyError):
        as_system("b200")
    with pytest.raises(TypeError):
        as_system(42)


def test_hetero_rate_match_v5p_prefill_v5e_decode():
    tol = 0.03
    kw = dict(isl=8192, osl=512, ftl_cutoff=10.0,
              ttl_targets=[0.02, 0.05, 0.2], tolerance=tol, max_chips=16)
    matched = dynamic_rate_match(model=LLAMA31_8B, prefill_sys=TPU_V5P,
                                 decode_sys=TPU_V5E, **kw)
    assert matched
    for r in matched:
        assert r.heterogeneous
        assert r.prefill_chip == "tpu-v5p" and r.decode_chip == "tpu-v5e"
        assert r.prefill.system.chip is TPU_V5P
        assert r.decode.system.chip is TPU_V5E
        assert r.num_prefill_chips > 0 and r.num_decode_chips > 0
        assert r.num_prefill_chips % r.prefill.mapping.chips == 0
        assert r.num_decode_chips % r.decode.mapping.chips == 0
        assert r.balance_residual <= tol + 1e-9, \
            (r.alpha, r.balance_residual)
        assert r.overall_tput_per_chip > 0
    jmatched = JR.dynamic_rate_match(model=JPM.LLAMA31_8B,
                                     prefill_sys="v5p", decode_sys="v5e",
                                     **kw)
    assert _plain(matched) == _plain(jmatched)


def test_hetero_frontier_beats_homog_on_prefill_heavy():
    kw = dict(max_chips=16, ttl_targets=[0.02, 0.05, 0.2])
    f_het = disaggregated_frontier(
        LLAMA31_8B, 8192, 256,
        hardware={"prefill": "v5p", "decode": "v5e"}, **kw)
    f_homog = disaggregated_frontier(LLAMA31_8B, 8192, 256, **kw)
    assert f_het and f_homog
    a_het = area_under_frontier(f_het, 10, 300)
    a_homog = area_under_frontier(f_homog, 10, 300)
    assert a_het >= a_homog, (a_het, a_homog)
    f_best = best_hardware_frontier(LLAMA31_8B, 8192, 256,
                                    ["v5e", "v5p"], **kw)
    for f in (f_het, f_homog):
        for x, y in f:
            assert frontier_at(f_best, x) >= y - 1e-9
    assert f_best == JF.best_hardware_frontier(JPM.LLAMA31_8B, 8192, 256,
                                               ["v5e", "v5p"], **kw)


def test_kv_transfer_uses_min_pool_dcn_bandwidth():
    slow_dcn = dataclasses.replace(TPU_V5E, name="slow-dcn",
                                   dcn_bw=TPU_V5E.dcn_bw / 2)
    kw = dict(isl=8192, osl=512, ftl=2.0, ttl=0.001,
              prefill_mapping=Mapping(chips=8, tp=8),
              decode_mapping=Mapping(chips=8, tp=8),
              prefill_batch=1, decode_batch=70)
    base = kv_transfer_requirement(LLAMA31_8B, **kw)
    het = kv_transfer_requirement(LLAMA31_8B, prefill_sys=TPU_V5P,
                                  decode_sys=slow_dcn, **kw)
    assert het.egress_bw == base.egress_bw
    assert het.ingress_bw == base.ingress_bw
    need = base.max_bw
    assert TPU_V5E.dcn_bw / 2 < need <= TPU_V5E.dcn_bw
    assert base.feasible and not het.feasible


@pytest.mark.parametrize("arch", ["qwen3-14b", "phi3-medium-14b"])
def test_frontiers_of_the_14b_models_match_reference(arch):
    """The disaggregated and co-located frontiers of the two 14B dense
    models on the H100 (their card here), heterogeneous h100:a100 too:
    the port's equal the reference's."""
    m, jm = get_perf_model(arch), JPM.get_perf_model(arch)
    kw = dict(max_chips=16, ttl_targets=default_ttl_targets(8))
    for hw in ({"prefill": "h100", "decode": "h100"},
               {"prefill": "h100", "decode": "a100"}):
        fd = disaggregated_frontier(m, 2048, 256, hardware=hw, **kw)
        assert fd and fd == JF.disaggregated_frontier(jm, 2048, 256,
                                                      hardware=hw, **kw)
    fc = colocated_frontier(m, 2048, 256, as_system("h100"), max_chips=16)
    assert fc and fc == JF.colocated_frontier(jm, 2048, 256,
                                              jas_system("h100"),
                                              max_chips=16)


def test_headline_finding_prefill_heavy_and_size():
    fd = disaggregated_frontier(DEEPSEEK_R1, 16384, 512, max_chips=128)
    fc = colocated_frontier(DEEPSEEK_R1, 16384, 512, max_chips=128)
    assert frontier_at(fd, 150) > frontier_at(fc, 150)
    fd8 = disaggregated_frontier(LLAMA31_8B, 8192, 512, max_chips=128)
    fc8 = colocated_frontier(LLAMA31_8B, 8192, 512, max_chips=128)
    a_d = area_under_frontier(fd8, 10, 300)
    a_c = area_under_frontier(fc8, 10, 300)
    assert a_d < 1.1 * a_c
    assert (fd, fc8) == (
        JF.disaggregated_frontier(JPM.DEEPSEEK_R1, 16384, 512,
                                  max_chips=128),
        JF.colocated_frontier(JPM.LLAMA31_8B, 8192, 512, max_chips=128))
