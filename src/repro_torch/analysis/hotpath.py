"""Hot-path complexity budget: the per-round serving loop, audited.

The port's copy of ``repro.analysis.hotpath``, the same logic.

Sim sweeps are only viable because the virtual-time event loop is cheap
(``benchmarks/sim_speed.py`` enforces a wall-time floor). The loop's cost
is dominated by what happens *per scheduling round*, so this pass builds
a call graph rooted at the round entry points (``Cluster.serve`` /
``Cluster._step`` / ``Cluster.decode_round``, from ``policy.json``),
over-approximates reachability by callee *name* (any indexed function
whose last name component matches a called name is considered reachable —
dynamic dispatch through policy seams resolves to every implementation),
and inside the reachable ("hot") set flags:

  - **hotpath-scan** — iteration over the whole fleet or queue: ``for``
    loops, comprehensions, and ``min/max/sorted/any/all/sum`` reductions
    whose iterable is a fleet accessor call (``engines()``,
    ``ready_requests()``, ...) or fleet attribute (``pools``,
    ``pending_insert``, ``queue``). These are O(n) per round; with n
    engines that is O(n^2) per simulated second.
  - **hotpath-alloc** — a fresh container per call: list/dict/set
    comprehensions and ``list()``/``sorted()`` calls. One allocation per
    round per engine adds up at sim_speed scales.

Every finding here is *budgeted*, not forbidden: the accepted ones live
in ``baseline.json`` with an annotated ``why`` (e.g. the three phase
loops in ``_step`` are the algorithm). The pass exists so a new scan or
allocation shows up as a diff against that budget and gets either
memoized (see ``Cluster.engines``/``ready_requests``) or justified —
never silently accreted.

Aliased iterables (``pre = cluster.prefill_pool; for e in pre``) are
deliberately not tracked: the pass under-approximates scans rather than
guessing, and the budget covers the direct-access idiom the loop uses.

Tracing call sites are held to the same budget: the loop reaches
``serving.tracing`` only through the ``rec = self.recorder; if rec is
not None`` guard, and a disabled recorder is collapsed to ``None`` at
``Cluster`` construction — so the off path contributes zero findings.
The fleet walks *inside* ``TraceRecorder`` (episode metadata capture,
rate-limited counter sampling) are enabled-path only and carry annotated
``why`` entries in ``baseline.json``.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set

from repro_torch.analysis.imports import Module, parse_module
from repro_torch.analysis.report import Violation

_REDUCTIONS = {"min", "max", "sorted", "any", "all", "sum", "len"}
_ALLOC_CALLS = {"list", "sorted"}
_VIEW_CALLS = {"values", "items", "keys"}

RULES = {
    "hotpath-scan": (
        "the round entry points run once per virtual-time step; an O(n) "
        "fleet or queue scan inside them is O(n^2) per simulated second and "
        "eats the sim_speed floor as fleets grow",
        "memoize the view (see Cluster.engines / ready_requests), hoist "
        "the scan out of the loop, or baseline it with a why if the scan "
        "is the algorithm"),
    "hotpath-alloc": (
        "a fresh container per round per engine dominates allocator time "
        "at sim sweep scales (thousands of rounds x engines per cell)",
        "reuse a preallocated structure, iterate lazily, or baseline it "
        "with a why if the copy is semantically required (snapshot "
        "before mutation)"),
}


@dataclasses.dataclass
class _Fn:
    qual: str                   # "Cluster._step" / "kv_bytes"
    module: Module
    node: ast.FunctionDef


def _index_functions(modules: Dict[str, Module], root: str,
                     names: List[str]) -> Dict[str, _Fn]:
    out: Dict[str, _Fn] = {}
    for mname in names:
        mod = modules.get(mname)
        if mod is None:
            continue
        tree = parse_module(mod, root)
        if tree is None:
            continue
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                out[f"{mname}:{node.name}"] = _Fn(node.name, mod, node)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        qual = f"{node.name}.{item.name}"
                        out[f"{mname}:{qual}"] = _Fn(qual, mod, item)
    return out


def _called_names(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                out.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                out.add(node.func.attr)
    return out


def _hot_set(index: Dict[str, _Fn], roots: List[str]) -> Set[str]:
    """BFS by callee name: over-approximate (every same-named function is
    reachable — exactly right for the pluggable policy seams)."""
    by_leaf: Dict[str, List[str]] = {}
    for key, fn in index.items():
        by_leaf.setdefault(fn.qual.rsplit(".", 1)[-1], []).append(key)
    frontier = [k for k, fn in index.items() if fn.qual in roots]
    hot = set(frontier)
    while frontier:
        key = frontier.pop()
        for name in _called_names(index[key].node):
            for callee in by_leaf.get(name, ()):
                if callee not in hot:
                    hot.add(callee)
                    frontier.append(callee)
    return hot


def _fleet_source(node: ast.expr, calls: Set[str],
                  attrs: Set[str]) -> Optional[str]:
    """The fleet accessor a (possibly wrapped) iterable reads, or None.
    Unwraps ``x.values()/.items()/.keys()``, subscripts, and generator
    expressions down to the accessor call or attribute."""
    if isinstance(node, ast.GeneratorExp):
        return _fleet_source(node.generators[0].iter, calls, attrs)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in calls:
                return node.func.attr + "()"
            if node.func.attr in _VIEW_CALLS:
                return _fleet_source(node.func.value, calls, attrs)
        elif isinstance(node.func, ast.Name) and node.func.id in calls:
            return node.func.id + "()"
        return None
    if isinstance(node, ast.Attribute):
        if node.attr in attrs:
            return node.attr
        return _fleet_source(node.value, calls, attrs)
    if isinstance(node, ast.Subscript):
        return _fleet_source(node.value, calls, attrs)
    if isinstance(node, ast.Name) and node.id in attrs:
        return node.id
    return None


def _snip(node: ast.AST) -> str:
    try:
        s = ast.unparse(node)
    except Exception:               # pragma: no cover - unparse is total
        return "<expr>"
    return s if len(s) <= 60 else s[:57] + "..."


class _HotVisitor(ast.NodeVisitor):
    def __init__(self, fn: _Fn, calls: Set[str], attrs: Set[str], emit):
        self.fn = fn
        self.calls = calls
        self.attrs = attrs
        self.emit = emit

    def _scan(self, node, iterable, what: str) -> None:
        src = _fleet_source(iterable, self.calls, self.attrs)
        if src is not None:
            self.emit("hotpath-scan",
                      f"{self.fn.qual}: {what} over {src} "
                      f"({_snip(iterable)})", node.lineno)

    def visit_For(self, node: ast.For) -> None:
        self._scan(node, node.iter, "for-loop")
        self.generic_visit(node)

    def _comp(self, node, kind: str) -> None:
        for gen in node.generators:
            self._scan(node, gen.iter, f"{kind}-comprehension")
        self.emit("hotpath-alloc",
                  f"{self.fn.qual}: {kind} comprehension allocates per "
                  f"call ({_snip(node)})", node.lineno)
        self.generic_visit(node)

    def visit_ListComp(self, node):
        self._comp(node, "list")

    def visit_SetComp(self, node):
        self._comp(node, "set")

    def visit_DictComp(self, node):
        self._comp(node, "dict")

    def visit_GeneratorExp(self, node: ast.GeneratorExp) -> None:
        for gen in node.generators:
            self._scan(node, gen.iter, "generator")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name):
            if node.func.id in _REDUCTIONS and node.args:
                self._scan(node, node.args[0],
                           f"{node.func.id}() reduction")
            if node.func.id in _ALLOC_CALLS and node.args:
                self.emit("hotpath-alloc",
                          f"{self.fn.qual}: {node.func.id}() copies its "
                          f"argument per call ({_snip(node)})",
                          node.lineno)
        self.generic_visit(node)


def check_hotpath(modules: Dict[str, Module], root: str,
                  policy: dict) -> List[Violation]:
    cfg = policy.get("hotpath")
    if not cfg:
        return []
    index = _index_functions(modules, root, cfg.get("modules", []))
    hot = _hot_set(index, cfg.get("roots", []))
    calls = set(cfg.get("fleet_calls", []))
    attrs = set(cfg.get("fleet_attrs", []))
    out: List[Violation] = []
    for key in sorted(hot):
        fn = index[key]

        def emit(rule: str, detail: str, lineno: int,
                 _fn=fn) -> None:
            out.append(Violation(rule, _fn.module.name, detail, lineno,
                                 _fn.module.path))
        _HotVisitor(fn, calls, attrs, emit).visit(fn.node)
    return out
