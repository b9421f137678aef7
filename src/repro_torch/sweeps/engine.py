"""The sweep engine: expand -> evaluate (vectorized, parallel) -> shard.

One ``SweepCell`` is the unit of everything: evaluation (the whole
mapping x batch design grid of that cell, as NumPy arrays), parallelism
(cells go to worker processes; the arrays inside a cell don't need to),
and storage (one shard per cell, written atomically, so interruption and
resume are shard-granular).

The evaluation path is torch-free: workers import only numpy + the
analytic core, so fork startup is cheap and a sweep can saturate every
host core while a serving run owns the card.

The port's copy of ``repro.sweeps.engine``. It differs in one place:
an architecture id resolves through the port's registry
(``repro_torch.configs``, through ``core.paper_models.get_perf_model``),
which imports torch in the worker that names one; the paper models need
nothing but numpy.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.design_space import _pow2
from repro_torch.core.frontiers import default_ttl_targets
from repro_torch.core.hardware import as_system
from repro_torch.core.paper_models import get_perf_model
from repro_torch.core.pareto import ParetoAccumulator, pareto_frontier
from repro_torch.core.perf_model import Mapping, PerfLLM
from repro_torch.sweeps.spec import SweepCell, SweepSpec
from repro_torch.sweeps.store import SweepStore
from repro_torch.sweeps.vectorized import (MappingGrid, decode_step_perf_vec,
                                     hbm_fits_vec, piggyback_step_perf_vec,
                                     prefill_perf_vec, rate_match_vec,
                                     sweep_decode_vec, sweep_prefill_vec)

AREA_WINDOW = (10.0, 300.0)     # tok/s/user window for versatility areas


def _mapping_tag(chips: int, tp: int, pp: int, dp: int, cpp: int,
                 batch: int) -> str:
    return f"g{chips}.tp{tp}.pp{pp}.dp{dp}.cpp{cpp}.b{batch}"


def _base_record(cell: SweepCell) -> dict:
    return {"model": cell.model, "mode": cell.mode,
            "prefill_chip": cell.prefill_chip,
            "decode_chip": cell.decode_chip,
            "isl": cell.isl, "osl": cell.osl, "reuse": cell.reuse}


def evaluate_cell(cell: SweepCell) -> Tuple[List[dict], dict]:
    """Pure function cell -> (records, meta); what workers execute.

    With ``cell.simulate`` the analytic records are joined by one
    ``kind="sim"`` row: a bounded ``Cluster.serve`` episode on the
    analytic-time ``SimEngine`` backend (``sweeps/simulate.py``), persisted
    in the same shard so resume/cache-hit semantics are unchanged.

    The meta carries only deterministic quantities — shard bytes must be
    identical across reruns, hosts, and PYTHONHASHSEEDs (the SweepStore
    cache contract; enforced by ``repro.analysis`` and the byte-stability
    regression test). Wall-clock timing lives in the in-memory
    ``SweepReport``, never in a shard."""
    model = get_perf_model(cell.model)
    if cell.mode == "disagg":
        records, points, grid_points = _eval_disagg(model, cell)
    else:
        records, points, grid_points = _eval_coloc(model, cell)
    if cell.simulate:
        from repro_torch.sweeps.simulate import simulate_cell
        records = records + simulate_cell(cell)
    meta = {"points": points, "grid_points": grid_points,
            "n_records": len(records)}
    return records, meta


def _eval_disagg(model: PerfLLM, cell: SweepCell
                 ) -> Tuple[List[dict], int, int]:
    pre_sys = as_system(cell.prefill_chip)
    dec_sys = as_system(cell.decode_chip)
    isl_eff = max(1, round(cell.isl * (1.0 - cell.reuse)))
    pre = sweep_prefill_vec(model, isl_eff, pre_sys,
                            max_chips=cell.max_chips, mem_isl=cell.isl)
    dec = sweep_decode_vec(model, cell.isl + cell.osl // 2, dec_sys,
                           max_chips=cell.max_chips,
                           max_ctx=cell.isl + cell.osl)
    targets = default_ttl_targets(cell.ttl_targets)
    matched = rate_match_vec(pre, dec, osl=cell.osl,
                             ftl_cutoff=cell.ftl_cutoff,
                             ttl_targets=targets, with_targets=True)
    records = []
    for target, r in matched:
        rec = _base_record(cell)
        rec.update({
            "ttl_target": target,
            "tps_per_user": r.tps_per_user,
            "tput_per_chip": r.overall_tput_per_chip,
            "tput_per_dollar": r.overall_tput_per_dollar,
            "ftl_s": r.ftl_s,
            "n_prefill_chips": r.num_prefill_chips,
            "n_decode_chips": r.num_decode_chips,
            "alpha": f"{r.alpha.numerator}/{r.alpha.denominator}",
            "pre_mapping": _mapping_tag(
                r.prefill.mapping.chips, r.prefill.mapping.tp,
                r.prefill.mapping.pp, r.prefill.mapping.dp_attn,
                r.prefill.mapping.cpp_chunks, r.prefill.batch),
            "dec_mapping": _mapping_tag(
                r.decode.mapping.chips, r.decode.mapping.tp,
                r.decode.mapping.pp, r.decode.mapping.dp_attn,
                r.decode.mapping.cpp_chunks, r.decode.batch),
        })
        records.append(rec)
    n_grid = pre.grid_total + dec.grid_total
    return records, len(pre) + len(dec), n_grid


def _coloc_grid(model: PerfLLM, sys_, max_chips: Optional[int]
                ) -> MappingGrid:
    """The co-located mapping grid of ``frontiers.colocated_frontier``:
    pp capped at 16, no CPP axis, batches to 1024."""
    maps: List[Mapping] = []
    for g in _pow2(1, max_chips or sys_.ici_domain):
        for pp in _pow2(1, min(g, 16)):
            if g % pp:
                continue
            for tp in _pow2(1, g // pp):
                if (g // pp) % tp:
                    continue
                m = Mapping(chips=g, tp=tp, pp=pp, dp_attn=g // (pp * tp))
                if m.valid(model, sys_):
                    maps.append(m)
    batches = _pow2(1, 1024)
    n_b = len(batches)
    rep = lambda xs: np.repeat(np.asarray(xs, dtype=np.int64), n_b)
    return MappingGrid(
        chips=rep([m.chips for m in maps]),
        tp=rep([m.tp for m in maps]),
        pp=rep([m.pp for m in maps]),
        dp=rep([m.dp_attn for m in maps]),
        cpp=rep([m.cpp_chunks for m in maps]),
        batch=np.tile(np.asarray(batches, dtype=np.int64), len(maps)))


def _eval_coloc(model: PerfLLM, cell: SweepCell
                ) -> Tuple[List[dict], int, int]:
    """Vectorized twin of ``frontiers.colocated_frontier`` (both the
    prefill-stall cycle and the piggybacked variant); only frontier
    points are persisted."""
    sys_ = as_system(cell.prefill_chip)
    isl, osl = cell.isl, cell.osl
    grid = _coloc_grid(model, sys_, cell.max_chips)
    n_grid = len(grid)
    fit = hbm_fits_vec(model, grid, isl + osl, sys_)
    g = grid.select(fit)
    if len(g) == 0:
        return [], 0, n_grid
    cost = sys_.chip.cost_per_hour

    d = decode_step_perf_vec(model, g, isl + osl // 2, sys_)
    pb_ = prefill_perf_vec(model, g, isl, sys_)
    chunk = np.minimum(
        np.maximum(1, np.floor(g.batch * isl
                               / max(osl, 1)).astype(np.int64)), isl)
    pb = piggyback_step_perf_vec(model, g, isl + osl // 2, chunk,
                                 isl // 2, sys_)
    points = 3 * len(g)

    b = g.batch.astype(np.float64)
    # non-piggybacked: full-batch prefill then osl decode steps (IFB stall)
    cycle = pb_.latency_s + osl * d.latency_s
    ok = pb_.latency_s < cell.ftl_cutoff
    x_np = osl / cycle            # 1 / ttl_eff
    y_np = b * osl / (cycle * g.chips)
    # piggybacked: uniform steps carrying a rate-balanced chunk
    ftl_pb = isl / chunk * pb.latency_s
    ok_pb = ftl_pb < cell.ftl_cutoff
    x_pb = 1.0 / pb.latency_s
    y_pb = b / (pb.latency_s * g.chips)
    variants = (("cycle", ok, x_np, y_np, pb_.latency_s),
                ("piggyback", ok_pb, x_pb, y_pb, ftl_pb))
    # persist only the frontier (a coloc cell has thousands of raw points;
    # the grid itself is reproducible from the cell params) — computed on
    # the arrays first so record dicts materialize per frontier point, not
    # per candidate
    cand_pts: List[tuple] = []
    for _, okm, xs, ys, _ in variants:
        idx = np.nonzero(okm)[0]
        cand_pts.extend(zip(xs[idx].tolist(), ys[idx].tolist()))
    frontier = set(pareto_frontier(cand_pts))
    seen = set()
    records = []
    for variant, okm, xs, ys, ftls in variants:
        for i in np.nonzero(okm)[0]:
            key = (float(xs[i]), float(ys[i]))
            if key not in frontier or key in seen:
                continue
            seen.add(key)
            rec = _base_record(cell)
            rec.update({
                "variant": variant,
                "tps_per_user": key[0],
                "tput_per_chip": key[1],
                "tput_per_dollar": key[1] / cost,
                "ftl_s": float(ftls[i]),
                "mapping": _mapping_tag(
                    int(g.chips[i]), int(g.tp[i]), int(g.pp[i]),
                    int(g.dp[i]), int(g.cpp[i]), int(g.batch[i])),
            })
            records.append(rec)
    return records, points, n_grid


# ---------------------------------------------------------------------------
# the driver


@dataclasses.dataclass
class SweepReport:
    spec_hash: str
    cells_total: int
    cells_cached: int
    cells_run: int
    points: int                 # perf-model evaluations (capacity-feasible)
    grid_points: int            # before the HBM mask
    records: int
    elapsed_s: float
    frontier_areas: Dict[str, float]   # "model/mode[/weight]" -> area

    @property
    def points_per_s(self) -> float:
        return self.points / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["points_per_s"] = round(self.points_per_s, 1)
        return d


def _eval_and_write(root: str, fmt: str, spec: SweepSpec,
                    cell: SweepCell) -> Tuple[str, dict]:
    """Worker entry point (module-level for pickling): evaluate one cell
    and persist its shard from inside the worker, so shard IO overlaps
    evaluation of other cells."""
    records, meta = evaluate_cell(cell)
    SweepStore(root, fmt).write_shard(spec, cell, records, meta)
    return cell.cell_id(), meta


def run_sweep(spec: SweepSpec, store: SweepStore, *, workers: int = 0,
              limit: Optional[int] = None, resume: bool = True,
              log=None) -> SweepReport:
    """Run (or resume) a sweep. ``workers=0`` evaluates inline;
    ``workers=N`` fans cells out to N processes. ``limit`` caps how many
    *pending* cells run this call (tests + incremental CI smoke).
    ``resume=False`` recomputes every cell even if its shard exists."""
    t0 = time.perf_counter()
    store.register(spec)
    cells = spec.cells()
    pending = store.pending(spec) if resume else list(cells)
    cached = len(cells) - len(pending) if resume else 0
    if limit is not None:
        pending = pending[:limit]

    acc: Dict[str, ParetoAccumulator] = {}
    acc_cost: Dict[str, ParetoAccumulator] = {}
    acc_sim: Dict[str, ParetoAccumulator] = {}

    def _accumulate(records):
        for r in records:
            key = f"{r['model']}/{r['mode']}"
            if r.get("kind") == "sim":      # simulated rows build their own
                acc_sim.setdefault(key, ParetoAccumulator()).add(
                    [(r["tps_per_user"], r["tput_per_chip"])])
                continue
            acc.setdefault(key, ParetoAccumulator()).add(
                [(r["tps_per_user"], r["tput_per_chip"])])
            acc_cost.setdefault(key, ParetoAccumulator()).add(
                [(r["tps_per_user"], r["tput_per_dollar"])])

    points = grid_points = n_records = 0

    def _ingest(meta):
        nonlocal points, grid_points
        points += meta["points"]
        grid_points += meta["grid_points"]

    # cached shards stream straight into the aggregates
    done_ids = {c.cell_id() for c in pending}
    for cell in cells:
        if cell.cell_id() in done_ids or not store.completed(spec, cell):
            continue
        records, meta = store.read_shard(spec, cell)
        _accumulate(records)
        n_records += len(records)
        if meta:
            _ingest(meta)

    ran = 0
    if pending:
        if workers and len(pending) > 1:
            with ProcessPoolExecutor(max_workers=workers) as pool:
                futs = {pool.submit(_eval_and_write, store.root, store.fmt,
                                    spec, c): c for c in pending}
                for fut in as_completed(futs):
                    cell_id, meta = fut.result()
                    cell = futs[fut]
                    records, _ = store.read_shard(spec, cell)
                    _accumulate(records)
                    n_records += len(records)
                    _ingest(meta)
                    ran += 1
                    if log:
                        log(f"[{ran}/{len(pending)}] {cell.model} "
                            f"{cell.mode} {cell_id} "
                            f"({meta['points']} pts)")
        else:
            for i, cell in enumerate(pending):
                records, meta = evaluate_cell(cell)
                store.write_shard(spec, cell, records, meta)
                _accumulate(records)
                n_records += len(records)
                _ingest(meta)
                ran += 1
                if log:
                    log(f"[{i + 1}/{len(pending)}] {cell.model} "
                        f"{cell.mode} {cell.cell_id()} "
                        f"({meta['points']} pts)")

    areas = {}
    for key in sorted(acc):
        areas[key] = round(acc[key].area(*AREA_WINDOW), 4)
        areas[key + "/cost"] = round(acc_cost[key].area(*AREA_WINDOW), 4)
    for key in sorted(acc_sim):
        areas[key + "/sim"] = round(acc_sim[key].area(*AREA_WINDOW), 4)
    return SweepReport(
        spec_hash=spec.spec_hash(), cells_total=len(cells),
        cells_cached=cached, cells_run=ran, points=points,
        grid_points=grid_points, records=n_records,
        elapsed_s=round(time.perf_counter() - t0, 4),
        frontier_areas=areas)
