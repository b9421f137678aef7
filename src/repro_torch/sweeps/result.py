"""Query API over a swept store: frontiers, hardware ranking, sensitivity.

``SweepResult`` is a read-side view — it never evaluates anything, it
filters + aggregates the records a sweep persisted, so navigating a
finished hundreds-of-thousands-of-points sweep is interactive.

The port's copy of ``repro.sweeps.result``, unchanged but for its
imports of the port's modules.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pareto import (area_under_frontier, frontier_at,
                               pareto_frontier)
from repro_torch.sweeps.spec import SweepSpec
from repro_torch.sweeps.store import SweepStore

Point = Tuple[float, float]

_WEIGHT_FIELD = {"chip": "tput_per_chip", "cost": "tput_per_dollar"}

# record fields usable as filter kwargs and sensitivity axes
AXES = ("model", "mode", "prefill_chip", "decode_chip", "isl", "osl",
        "reuse")

# records carry kind="sim" when produced by the simulator-in-the-loop
# episode (sweeps/simulate.py); analytic rows predate the field and are
# normalized to "analytic" at filter time
KINDS = ("analytic", "sim")


class SweepResult:
    def __init__(self, store: SweepStore, spec: SweepSpec):
        self.store = store
        self.spec = spec
        self._records: Optional[List[dict]] = None

    # -- record access ------------------------------------------------------

    def records(self, **filters) -> List[dict]:
        """Completed records matching ``filters`` (field=value, or
        field=list-of-values). Loaded once, filtered per call.
        ``kind="analytic"`` / ``kind="sim"`` separates the perf-model rows
        from simulator-in-the-loop rows (absent field = analytic)."""
        if self._records is None:
            self._records = list(self.store.iter_records(self.spec))
        for k in filters:
            if k not in AXES and k not in ("variant", "kind"):
                raise KeyError(f"unknown filter {k!r}; filterable: "
                               f"{AXES + ('variant', 'kind')}")
        out = []
        for r in self._records:
            ok = True
            for k, v in filters.items():
                vs = v if isinstance(v, (list, tuple, set)) else (v,)
                got = ((r.get("kind") or "analytic") if k == "kind"
                       else r.get(k))
                if got not in vs:
                    ok = False
                    break
            if ok:
                out.append(r)
        return out

    def invalidate(self) -> None:
        """Drop the record cache (after resuming more cells)."""
        self._records = None

    # -- frontiers ----------------------------------------------------------

    def frontier(self, weight: str = "chip", **filters) -> List[Point]:
        """Pareto frontier of the filtered records; ``weight="cost"``
        puts tokens/s per $/hour on the y-axis (throughput per dollar,
        not per chip). Analytic rows only unless ``kind=`` is passed —
        simulated rows live on a different deployment scale and must not
        silently mix into the analytic frontier."""
        field = _WEIGHT_FIELD[weight]
        filters.setdefault("kind", "analytic")
        return pareto_frontier(
            [(r["tps_per_user"], r[field]) for r in self.records(**filters)])

    def area(self, window: Tuple[float, float] = (10.0, 300.0),
             weight: str = "chip", **filters) -> float:
        return area_under_frontier(self.frontier(weight, **filters),
                                   *window)

    def best_hardware(self, weight: str = "chip",
                      window: Tuple[float, float] = (10.0, 300.0),
                      **filters) -> List[Tuple[Tuple[str, str], float]]:
        """Hardware pairs ranked by frontier area over the interactivity
        window, best first. With ``weight="cost"`` the ranking is
        throughput-per-dollar — the answer to "which silicon should I
        buy", where per-chip weighting answers "which is fastest"."""
        out: List[Tuple[Tuple[str, str], float]] = []
        for pre, dec in sorted({(r["prefill_chip"], r["decode_chip"])
                                for r in self.records(**filters)}):
            # pair keys override any caller filter on the same axis (the
            # pair set is already restricted by it)
            a = self.area(window, weight,
                          **{**filters, "prefill_chip": pre,
                             "decode_chip": dec})
            out.append(((pre, dec), a))
        out.sort(key=lambda t: (-t[1], t[0]))
        return out

    def sensitivity(self, axis: str, weight: str = "chip",
                    window: Tuple[float, float] = (10.0, 300.0),
                    **filters) -> List[Tuple[object, float]]:
        """Frontier area as a function of one sweep axis, everything else
        pooled (or pinned via ``filters``) — e.g. ``sensitivity("isl")``
        shows how the achievable frontier decays as prompts grow, and
        ``sensitivity("reuse")`` how much KV reuse buys back."""
        if axis not in AXES:
            raise KeyError(f"unknown axis {axis!r}; axes: {AXES}")
        values = sorted({r[axis] for r in self.records(**filters)})
        return [(v, self.area(window, weight, **{**filters, axis: v}))
                for v in values]

    # -- simulator-in-the-loop views ----------------------------------------

    def sim_records(self, **filters) -> List[dict]:
        """The ``kind="sim"`` rows (one bounded serve episode per cell).
        A caller-supplied ``kind`` filter is overridden — these helpers
        are the sim view by definition."""
        filters["kind"] = "sim"
        return self.records(**filters)

    def sim_frontier(self, weight: str = "chip", **filters) -> List[Point]:
        """Pareto frontier over the simulated episodes' (tps_per_user,
        tput) points."""
        filters["kind"] = "sim"
        return self.frontier(weight, **filters)

    def sim_delta(self, weight: str = "chip", **filters) -> List[dict]:
        """Analytic-vs-simulated deltas, one row per simulated cell.

        For each sim record, evaluates the *analytic* frontier of the same
        (model, mode, hardware, isl, osl, reuse) cell at the simulated
        interactivity and reports the ratio ``sim / analytic``. The
        analytic number is an upper envelope (ideal rate matching, no
        queueing, the best mapping over the whole chips axis), so ratios
        land below 1; how far below — and whether the *ordering* of design
        points agrees — is exactly what the executable loop adds."""
        field = _WEIGHT_FIELD[weight]
        sims = self.sim_records(**filters)
        if not sims:
            return []
        # one pass over the analytic rows, grouped by cell coordinate —
        # not one full record scan per simulated cell (paper-scale stores
        # hold 10^5-10^6 analytic rows)
        by_coord: Dict[tuple, List[Point]] = {}
        for r in self.records(kind="analytic"):
            by_coord.setdefault(tuple(r[k] for k in AXES), []).append(
                (r["tps_per_user"], r[field]))
        out = []
        for r in sims:
            coord = {k: r[k] for k in AXES}
            f = pareto_frontier(by_coord.get(tuple(coord.values()), []))
            analytic = frontier_at(f, r["tps_per_user"]) if f else 0.0
            out.append({
                **coord,
                "tps_per_user": r["tps_per_user"],
                f"sim_{field}": r[field],
                f"analytic_{field}": analytic,
                # None (JSON null), not NaN: an infeasible analytic cell
                # must not poison strict-JSON consumers of --query output
                "ratio": (r[field] / analytic if analytic > 0 else None),
            })
        return out

    def summary(self) -> Dict[str, object]:
        recs = self.records()
        sim = [r for r in recs if r.get("kind") == "sim"]
        return {
            "spec_hash": self.spec.spec_hash(),
            "records": len(recs),
            "sim_records": len(sim),
            "models": sorted({r["model"] for r in recs}),
            "modes": sorted({r["mode"] for r in recs}),
            "hardware": sorted({f"{r['prefill_chip']}:{r['decode_chip']}"
                                for r in recs}),
        }
