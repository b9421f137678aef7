"""Declarative sweep specifications: the grid, hashed and expanded.

A ``SweepSpec`` names *what* to sweep — models x hardware pairs x traffic
shapes (ISL/OSL/reuse) x serving modes — plus the shared evaluation knobs
(TTL targets, FTL cutoff, chip budget). ``expand()`` turns it into the
flat list of ``SweepCell`` evaluation tasks; ``spec_hash()`` is the
content address under which ``SweepStore`` shards results, so the same
grid re-swept anywhere is a cache hit and a *superset* grid reuses every
overlapping cell (cells are hashed independently of the spec that first
produced them).

The port's copy of ``repro.sweeps.spec``, unchanged but for its import of
the port's chip registry: the same grid hashes to the same ``spec_hash``
and cell ids in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.core.hardware import get_chip

MODES = ("disagg", "coloc")

HardwarePairLike = Union[str, Tuple[str, str], Sequence[str], Dict[str, str]]


def _canon_pair(hw: HardwarePairLike) -> Tuple[str, str]:
    """Normalize a hardware entry to a canonical (prefill, decode) chip
    name pair: "v5e" -> ("tpu-v5e", "tpu-v5e"); "v5p:v5e" or
    ("v5p", "v5e") or {"prefill": "v5p", "decode": "v5e"} -> hetero."""
    if isinstance(hw, str):
        parts = hw.split(":")
        if len(parts) == 1:
            parts = [hw, hw]
        assert len(parts) == 2, f"bad hardware pair {hw!r}"
        pre, dec = parts
    elif isinstance(hw, dict):
        pre = hw.get("prefill") or next(iter(hw.values()))
        dec = hw.get("decode") or pre
    else:
        pre, dec = hw
    return get_chip(pre).name, get_chip(dec).name


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One evaluation task: a single (model, mode, hardware, shape) cell.
    Each cell expands internally to the full mapping x batch design grid
    (hundreds to thousands of perf-model points) and reduces to its
    rate-matched / co-located frontier records — the unit of work, of
    multiprocessing, and of on-disk sharding."""
    model: str
    mode: str                  # "disagg" | "coloc"
    prefill_chip: str          # canonical chip name; == decode_chip for coloc
    decode_chip: str
    isl: int
    osl: int
    reuse: float
    ttl_targets: int
    ftl_cutoff: float
    max_chips: Optional[int]
    # simulator-in-the-loop: run a bounded Cluster.serve episode on
    # SimEngines next to the analytic evaluation (sweeps/simulate.py)
    simulate: bool = False
    sim_requests: int = 0

    def canonical(self) -> dict:
        d = dataclasses.asdict(self)
        if not self.simulate:       # hash-compatible with pre-sim cells:
            del d["simulate"]       # analytic-only shards keep their ids
            del d["sim_requests"]
        return d

    def cell_id(self) -> str:
        """Content address of this cell — independent of the enclosing
        spec, so overlapping specs share shards."""
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @property
    def heterogeneous(self) -> bool:
        return self.prefill_chip != self.decode_chip


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The declarative grid. Build via ``SweepSpec.create`` (normalizes,
    sorts, and validates every axis so equal grids hash equally)."""
    models: Tuple[str, ...]
    hardware: Tuple[Tuple[str, str], ...]
    isl: Tuple[int, ...]
    osl: Tuple[int, ...]
    reuse: Tuple[float, ...] = (0.0,)
    modes: Tuple[str, ...] = ("disagg",)
    ttl_targets: int = 24
    ftl_cutoff: float = 10.0
    max_chips: Optional[int] = None
    # simulator-in-the-loop axis: each cell additionally runs a bounded
    # Cluster.serve episode on SimEngines and records sla_metrics columns
    simulate: bool = False
    sim_requests: int = 24

    @classmethod
    def create(cls, models: Sequence[str],
               hardware: Sequence[HardwarePairLike],
               isl: Sequence[int], osl: Sequence[int],
               reuse: Sequence[float] = (0.0,),
               modes: Sequence[str] = ("disagg",),
               ttl_targets: int = 24, ftl_cutoff: float = 10.0,
               max_chips: Optional[int] = None,
               simulate: bool = False,
               sim_requests: int = 24) -> "SweepSpec":
        pairs = sorted({_canon_pair(h) for h in hardware})
        assert pairs, "need at least one hardware entry"
        assert models, "need at least one model"
        for m in modes:
            assert m in MODES, f"mode must be one of {MODES}: {m!r}"
        for r in reuse:
            assert 0.0 <= r < 1.0, f"reuse_fraction in [0, 1): {r}"
        assert ttl_targets >= 1 and ftl_cutoff > 0
        assert not simulate or sim_requests >= 1, \
            "simulate=True needs sim_requests >= 1"
        return cls(models=tuple(sorted(set(models))),
                   hardware=tuple(pairs),
                   isl=tuple(sorted(set(int(i) for i in isl))),
                   osl=tuple(sorted(set(int(o) for o in osl))),
                   reuse=tuple(sorted(set(float(r) for r in reuse))),
                   modes=tuple(sorted(set(modes))),
                   ttl_targets=int(ttl_targets),
                   ftl_cutoff=float(ftl_cutoff),
                   max_chips=max_chips,
                   simulate=bool(simulate),
                   sim_requests=int(sim_requests))

    # -- serialization ------------------------------------------------------

    def canonical(self) -> dict:
        d = dataclasses.asdict(self)
        d["hardware"] = [list(p) for p in self.hardware]
        if not self.simulate:       # analytic-only specs hash as before
            del d["simulate"]
            del d["sim_requests"]
        return d

    def to_json(self) -> str:
        return json.dumps(self.canonical(), sort_keys=True, indent=1)

    @classmethod
    def from_dict(cls, d: dict) -> "SweepSpec":
        return cls.create(
            models=d["models"], hardware=d["hardware"], isl=d["isl"],
            osl=d["osl"], reuse=d.get("reuse", (0.0,)),
            modes=d.get("modes", ("disagg",)),
            ttl_targets=d.get("ttl_targets", 24),
            ftl_cutoff=d.get("ftl_cutoff", 10.0),
            max_chips=d.get("max_chips"),
            simulate=d.get("simulate", False),
            sim_requests=d.get("sim_requests", 24))

    def spec_hash(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- expansion ----------------------------------------------------------

    def expand(self) -> Iterator[SweepCell]:
        """Flat task list, deterministic order. Co-located cells run one
        mixed pool on the *prefill* chip of each pair; heterogeneous pairs
        therefore collapse onto their homogeneous prefill-chip cell and
        are deduped."""
        seen = set()
        for model in self.models:
            for mode in self.modes:
                for pre, dec in self.hardware:
                    if mode == "coloc":
                        pre_c, dec_c = pre, pre
                    else:
                        pre_c, dec_c = pre, dec
                    for isl in self.isl:
                        for osl in self.osl:
                            for reuse in self.reuse:
                                if mode == "coloc" and reuse > 0.0:
                                    # the co-located perf model has no
                                    # prefix-cache term (workload_frontier
                                    # contract); reuse axes collapse to 0
                                    reuse = 0.0
                                cell = SweepCell(
                                    model=model, mode=mode,
                                    prefill_chip=pre_c, decode_chip=dec_c,
                                    isl=isl, osl=osl, reuse=reuse,
                                    ttl_targets=self.ttl_targets,
                                    ftl_cutoff=self.ftl_cutoff,
                                    max_chips=self.max_chips,
                                    simulate=self.simulate,
                                    sim_requests=(self.sim_requests
                                                  if self.simulate else 0))
                                cid = cell.cell_id()
                                if cid not in seen:
                                    seen.add(cid)
                                    yield cell

    def cells(self) -> List[SweepCell]:
        return list(self.expand())

    def n_cells(self) -> int:
        return sum(1 for _ in self.expand())
