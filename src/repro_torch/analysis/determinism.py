"""Determinism linter: reproducibility hazards in sim/sweep/store code.

The port's copy of ``repro.analysis.determinism``, unchanged.

Sweep shards must be byte-stable across reruns, hosts, and
``PYTHONHASHSEED``s (the SweepStore cache-hit contract), and the sim
backend must replay identical schedules. This linter flags the patterns
that historically break that, per policy group:

``serialized`` groups (sweeps, simengine, cluster/policies, workloads):
  - ``unseeded-rng``    ``np.random.default_rng()`` with no seed
  - ``global-rng``      legacy ``np.random.<fn>`` globals and any use of
                        the stdlib ``random`` module (one hidden global
                        stream, seeded per-process)
  - ``wallclock``       ``time.time/ time_ns / perf_counter / monotonic``,
                        ``datetime.now/utcnow``, ``date.today`` — wall
                        time read inside code whose outputs are persisted
  - ``set-order``       iterating a set (or ``list(set(...))``) — order
                        varies with ``PYTHONHASHSEED``; wrap in ``sorted``
  - ``json-sort-keys``  ``json.dump(s)`` without ``sort_keys=True``

``frontier`` groups (Pareto/area accumulation):
  - ``float-sum``       builtin ``sum`` — use ``math.fsum`` so frontier
                        areas don't drift with summation order

Findings are allowlisted via the baseline (``report.apply_baseline``):
a site that is *known* to be report-only (e.g. ``run_sweep``'s elapsed
telemetry, which never reaches a shard) is accepted there, and CI fails
only on growth.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.imports import Module, _match_any
from repro_torch.analysis.report import Violation

_NUMPY_GLOBAL_FNS = {
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "uniform", "normal", "seed",
}
_WALLCLOCK_TIME_FNS = {"time", "time_ns", "perf_counter", "monotonic"}
_WALLCLOCK_DT_FNS = {"now", "utcnow", "today"}


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name of an attribute/name chain ('' if not)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _DetVisitor(ast.NodeVisitor):
    def __init__(self, module: Module, checks: List[str]):
        self.module = module
        self.checks = set(checks)
        self.violations: List[Violation] = []
        # names bound by `from X import y` that we care about
        self._from_numpy_random: set = set()
        self._from_random: set = set()
        self._from_time: set = set()
        self._from_datetime: set = set()
        self._random_module_aliases: set = set()

    def _emit(self, rule: str, detail: str, lineno: int) -> None:
        if rule in self.checks:
            self.violations.append(Violation(
                rule, self.module.name, detail, lineno, self.module.path))

    # -- track import aliases ----------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "random":
                self._random_module_aliases.add(a.asname or "random")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for a in node.names:
            bound = a.asname or a.name
            if mod == "numpy.random":
                self._from_numpy_random.add(bound)
            elif mod == "random":
                self._from_random.add(bound)
            elif mod == "time":
                self._from_time.add(bound)
            elif mod == "datetime":
                self._from_datetime.add(bound)

    # -- call-site checks ---------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        self._check_rng(node, name)
        self._check_wallclock(node, name)
        self._check_json(node, name)
        self._check_set_order(node, name)
        self._check_sum(node, name)
        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, name: str) -> None:
        leaf = name.rsplit(".", 1)[-1]
        if (leaf == "default_rng"
                and (".random.default_rng" in "." + name
                     or name in self._from_numpy_random)):
            if not node.args and not node.keywords:
                self._emit("unseeded-rng",
                           "default_rng() without a seed "
                           "(results vary per process)", node.lineno)
            return
        parts = name.split(".")
        if (len(parts) >= 3 and parts[-2] == "random"
                and parts[-1] in _NUMPY_GLOBAL_FNS):
            self._emit("global-rng",
                       f"legacy global rng np.random.{parts[-1]}() "
                       "(hidden process-wide state)", node.lineno)
        elif (len(parts) == 2 and parts[0] in self._random_module_aliases):
            self._emit("global-rng",
                       f"stdlib random.{parts[1]}() "
                       "(hidden process-wide state)", node.lineno)
        elif len(parts) == 1 and parts[0] in self._from_random:
            self._emit("global-rng",
                       f"stdlib random.{parts[0]}() "
                       "(hidden process-wide state)", node.lineno)

    def _check_wallclock(self, node: ast.Call, name: str) -> None:
        parts = name.split(".")
        leaf = parts[-1]
        if len(parts) >= 2 and parts[-2] == "time" \
                and leaf in _WALLCLOCK_TIME_FNS:
            self._emit("wallclock", f"time.{leaf}()", node.lineno)
        elif len(parts) == 1 and leaf in self._from_time \
                and leaf in _WALLCLOCK_TIME_FNS:
            self._emit("wallclock", f"time.{leaf}()", node.lineno)
        elif leaf in _WALLCLOCK_DT_FNS and len(parts) >= 2 \
                and parts[-2] in ({"datetime", "date"}
                                  | self._from_datetime):
            self._emit("wallclock", f"{parts[-2]}.{leaf}()", node.lineno)

    def _check_json(self, node: ast.Call, name: str) -> None:
        if name not in ("json.dump", "json.dumps"):
            return
        for kw in node.keywords:
            if kw.arg == "sort_keys":
                if isinstance(kw.value, ast.Constant) and kw.value.value:
                    return
        self._emit("json-sort-keys",
                   f"{name}() without sort_keys=True "
                   "(dict order leaks into serialized bytes)", node.lineno)

    def _is_set_expr(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "set")

    def _check_set_order(self, node: ast.Call, name: str) -> None:
        if name in ("list", "tuple") and node.args \
                and self._is_set_expr(node.args[0]):
            self._emit("set-order",
                       f"{name}(set(...)) materializes hash order; "
                       "use sorted(...)", node.lineno)

    def visit_For(self, node: ast.For) -> None:
        if self._is_set_expr(node.iter):
            self._emit("set-order",
                       "iterating a set (hash order varies with "
                       "PYTHONHASHSEED); use sorted(...)", node.lineno)
        self.generic_visit(node)

    def _check_sum(self, node: ast.Call, name: str) -> None:
        if name == "sum":
            self._emit("float-sum",
                       "builtin sum() in frontier-area code; use "
                       "math.fsum for order-stable accumulation",
                       node.lineno)


SERIALIZED_CHECKS = ["unseeded-rng", "global-rng", "wallclock",
                     "set-order", "json-sort-keys"]


def check_determinism(modules: Dict[str, Module], root: str,
                      groups: List[dict]) -> List[Violation]:
    """Run each policy group's checks over its matching modules. Groups:
    ``{"name": ..., "modules": [patterns], "checks": [rule names]}``."""
    from repro_torch.analysis.imports import parse_module
    out: List[Violation] = []
    for group in groups:
        checks = group["checks"]
        for mod in modules.values():
            if not _match_any(mod.name, group["modules"]):
                continue
            tree = parse_module(mod, root)
            if tree is None:
                continue            # reported by the import checker
            v = _DetVisitor(mod, checks)
            v.visit(tree)
            out.extend(v.violations)
    return out
