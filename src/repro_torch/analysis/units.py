"""Dimensional-consistency checker: units inferred from naming convention.

The port's copy of ``repro.analysis.units``, unchanged.

Every number this repo publishes flows through hand-written unit
arithmetic in ``core/perf_model.py`` / ``core/rate_matching.py``; one
silent seconds-vs-bytes (or per-token-vs-total) slip corrupts every sweep
shard without failing a test. This pass infers a unit for each name from
the codebase's suffix convention —

    _s _ms _us _bytes _tokens _flops _hz _hour(s) _dollar(s)/usd
    ..._per_<unit>      (recursively: tokens_per_s, cost_per_hour)
    ...bw               (a bandwidth: bytes/s)

— plus a small annotation registry in ``policy.json`` for unsuffixed
names (``latency: "s"``, ``peak: "flops/s"``, ``isl: "tokens"``), and
propagates units through assignments, arithmetic, returns, and function
signatures. Count-like dimensions (``chips``, ``layers``, ``users``,
``reqs``) are treated as dimensionless so ``bytes_per_chip`` adds
cleanly with ``bytes`` — per-chip vs total is sliced by the mapping
algebra, not by this checker.

Rules (all conservative: an unknown operand silences the check — the
pass flags contradictions between *declared* units, never guesses):

  - ``unit-mismatch-add``      ``x_s + y_bytes`` (also ``-``, ``+=``)
  - ``unit-mismatch-compare``  ``x_s < y_bytes`` (also min/max args)
  - ``unit-return-mismatch``   a ``*_s`` function returning a bytes expr
  - ``unit-bind-mismatch``     a derived unit contradicting the target
                               name's declared suffix/registry unit
  - ``unit-unsuffixed-bind``   arithmetic deriving a pure time or byte
                               quantity bound to an unsuffixed,
                               unregistered name — rename it (``exposed``
                               -> ``exposed_s``) so readers and this
                               checker both see the dimension
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.imports import Module, _match_any, parse_module
from repro_torch.analysis.report import Violation

# A unit is a dict: base dimension -> integer exponent ({} = dimensionless).
# Two sentinels thread through inference:
#   ANY     a bare numeric literal — compatible with everything
#   None    unknown — poisons products and silences checks
Unit = Dict[str, int]
ANY = "any"

# name token -> base dimension ([] = an ignored count-like dimension)
_UNIT_TOKENS: Dict[str, Optional[str]] = {
    "s": "s", "sec": "s", "secs": "s", "second": "s", "seconds": "s",
    "ms": "ms", "us": "us", "ns": "ns",
    "byte": "bytes", "bytes": "bytes", "nbytes": "bytes",
    "tok": "tokens", "toks": "tokens", "token": "tokens",
    "tokens": "tokens",
    "flop": "flops", "flops": "flops",
    "hour": "hour", "hours": "hour",
    "dollar": "usd", "dollars": "usd", "usd": "usd",
}
# count-like tokens: legal in unit position, contribute no dimension
_COUNT_TOKENS = {
    "chip", "chips", "user", "users", "req", "reqs", "request", "requests",
    "seq", "seqs", "layer", "layers", "engine", "engines", "slot", "slots",
    "step", "steps", "op", "ops", "instance", "instances",
}

_INTERESTING = ({"s": 1}, {"bytes": 1})    # dims worth a rename demand

RULES = {
    "unit-mismatch-add": (
        "adding or subtracting two quantities whose inferred units differ "
        "(e.g. seconds + bytes) is the silent corruption class this pass "
        "exists for — every downstream sweep shard inherits the garbage",
        "convert one operand explicitly, or fix the name whose suffix "
        "mis-declares its unit"),
    "unit-mismatch-compare": (
        "comparing (or min/max-ing) quantities of different units always "
        "returns an answer and it is always meaningless",
        "compare like with like; if a name's suffix is wrong, rename it"),
    "unit-return-mismatch": (
        "a function whose name declares a unit (*_s, *_bytes) is an API "
        "contract; returning a different dimension breaks every caller "
        "that trusted the name",
        "fix the returned expression or rename the function"),
    "unit-bind-mismatch": (
        "the right-hand side derives one unit but the target name's "
        "suffix or registry annotation declares another — one of them is "
        "lying",
        "rename the target to match the derived unit, or fix the "
        "arithmetic"),
    "unit-unsuffixed-bind": (
        "arithmetic produced a pure time or byte quantity, but it was "
        "bound to a name that declares nothing — the next reader (and "
        "this checker) lose the dimension there",
        "rename the local with the unit suffix (exposed -> exposed_s); "
        "registry entries in policy.json are for names that cannot "
        "change (public API)"),
}


def parse_unit_str(s: str) -> Unit:
    """``"bytes/s"`` / ``"flops_per_s"`` / ``""`` -> a Unit dict."""
    s = s.strip().replace("_per_", "/")
    if not s:
        return {}
    out: Unit = {}
    num, _, rest = s.partition("/")
    parts = [(num, 1)] + [(d, -1) for d in rest.split("/") if d]
    for tok, sign in parts:
        for t in tok.split("*"):
            t = t.strip()
            if not t:
                continue
            dim = _UNIT_TOKENS.get(t)
            if dim is None and t not in _COUNT_TOKENS:
                raise ValueError(f"unknown unit token {t!r} in {s!r}")
            if dim is not None:
                out[dim] = out.get(dim, 0) + sign
    return {d: e for d, e in out.items() if e}


def unit_to_str(u: Unit) -> str:
    if not u:
        return "1"
    num = sorted(d for d, e in u.items() if e > 0 for _ in range(e))
    den = sorted(d for d, e in u.items() if e < 0 for _ in range(-e))
    s = "*".join(num) or "1"
    return s + ("/" + "/".join(den) if den else "")


def unit_from_name(name: str, registry: Dict[str, Unit]) -> Optional[Unit]:
    """Declared unit of a name: registry full-name match, then registry
    last-token match (``_prefill_latency`` hits the ``latency`` entry),
    then the suffix grammar ``<stuff>_<unit>[_per_<unit>...]``."""
    low = name.lower()
    if low in registry:
        return dict(registry[low])
    toks = [t for t in low.split("_") if t]
    if not toks:
        return None
    if toks[-1] in registry and len(toks[-1]) > 1:
        return dict(registry[toks[-1]])
    denom: Unit = {}
    while len(toks) >= 2 and toks[-2] == "per" and (
            toks[-1] in _UNIT_TOKENS or toks[-1] in _COUNT_TOKENS):
        dim = _UNIT_TOKENS.get(toks[-1])
        if dim is not None:
            denom[dim] = denom.get(dim, 0) - 1
        toks = toks[:-2]
    if toks and toks[-1] == "bw":
        return _mul({"bytes": 1, "s": -1}, denom)
    if toks and toks[-1] in _UNIT_TOKENS:
        return _mul({_UNIT_TOKENS[toks[-1]]: 1}, denom)
    if toks and toks[-1] in registry:
        return _mul(registry[toks[-1]], denom)      # cost_per_hour
    if toks and toks[-1] in _COUNT_TOKENS and denom:
        return dict(denom)
    if denom:
        return None                 # unknown numerator: tput_per_dollar
    return None


def _mul(a: Unit, b: Unit, sign: int = 1) -> Unit:
    out = dict(a)
    for d, e in b.items():
        out[d] = out.get(d, 0) + sign * e
    return {d: e for d, e in out.items() if e}


class _FnChecker(ast.NodeVisitor):
    """Per-function unit inference; nested defs get their own checker."""

    def __init__(self, pass_: "_UnitsPass", fn: ast.AST, qual: str):
        self.p = pass_
        self.fn = fn
        self.qual = qual
        self.env: Dict[str, Optional[Unit]] = {}
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if a.arg not in ("self", "cls"):
                self.env[a.arg] = unit_from_name(a.arg, self.p.registry)
        self.declared = unit_from_name(
            getattr(fn, "name", ""), self.p.registry)

    # -- inference ----------------------------------------------------------

    def infer(self, node: ast.expr):
        """Unit of an expression: a Unit dict, ANY (literal), or None."""
        if isinstance(node, ast.Constant):
            return ANY if isinstance(node.value, (int, float)) else None
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return unit_from_name(node.id, self.p.registry)
        if isinstance(node, ast.Attribute):
            return unit_from_name(node.attr, self.p.registry)
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand)
        if isinstance(node, ast.IfExp):
            return self._join(self.infer(node.body),
                              self.infer(node.orelse))
        if isinstance(node, ast.Call):
            return self._infer_call(node)
        if isinstance(node, ast.BinOp):
            return self._infer_binop(node)
        if isinstance(node, ast.Compare):
            self._check_units_agree(
                [node.left] + list(node.comparators), node,
                "unit-mismatch-compare", "compared")
            return None
        return None

    def _join(self, a, b):
        """Unit of 'either branch': agree -> that unit; literal defers."""
        if a is ANY or a is None:
            return b if a is ANY else (b if b is ANY else None)
        if b is ANY:
            return a
        return a if a == b else None

    def _infer_call(self, node: ast.Call):
        leaf = ""
        if isinstance(node.func, ast.Name):
            leaf = node.func.id
        elif isinstance(node.func, ast.Attribute):
            leaf = node.func.attr
        if leaf in ("min", "max"):
            self._check_units_agree(node.args, node,
                                    "unit-mismatch-compare", leaf)
        if leaf in ("min", "max", "abs", "int", "float", "round"):
            units = [self.infer(a) for a in node.args]
            known = [u for u in units if u is not None and u is not ANY]
            if known and all(u == known[0] for u in known):
                return known[0]
            return ANY if units and all(u is ANY for u in units) else None
        return unit_from_name(leaf, self.p.registry)

    def _infer_binop(self, node: ast.BinOp):
        lu, ru = self.infer(node.left), self.infer(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._flag_mismatch(lu, ru, node, "unit-mismatch-add",
                                "+" if isinstance(node.op, ast.Add)
                                else "-")
            return self._join(lu, ru)
        if isinstance(node.op, ast.Mult):
            if lu is None or ru is None:
                return None
            return _mul({} if lu is ANY else lu, {} if ru is ANY else ru)
        if isinstance(node.op, (ast.Div, ast.FloorDiv)):
            if lu is None or ru is None:
                return None
            return _mul({} if lu is ANY else lu,
                        {} if ru is ANY else ru, sign=-1)
        if isinstance(node.op, ast.Pow):
            if (isinstance(node.right, ast.Constant)
                    and isinstance(node.right.value, int)
                    and lu not in (None, ANY)):
                return {d: e * node.right.value for d, e in lu.items()}
            return ANY if lu is ANY else None
        return None

    # -- violations ---------------------------------------------------------

    def _flag_mismatch(self, lu, ru, node, rule: str, opname: str) -> None:
        if lu in (None, ANY) or ru in (None, ANY) or lu == ru:
            return
        self.p.emit(rule,
                    f"{self.qual}: '{unit_to_str(lu)}' {opname} "
                    f"'{unit_to_str(ru)}' "
                    f"({self._src(node)})", node.lineno)

    def _check_units_agree(self, exprs, node, rule: str, what: str) -> None:
        units = [(e, self.infer(e)) for e in exprs]
        known = [(e, u) for e, u in units if u not in (None, ANY)]
        for (e1, u1), (e2, u2) in zip(known, known[1:]):
            if u1 != u2:
                self.p.emit(rule,
                            f"{self.qual}: {what} '{unit_to_str(u1)}' vs "
                            f"'{unit_to_str(u2)}' "
                            f"({self._src(node)})", node.lineno)
                return

    def _src(self, node) -> str:
        try:
            s = ast.unparse(node)
        except Exception:           # pragma: no cover - unparse is total
            return "<expr>"
        return s if len(s) <= 60 else s[:57] + "..."

    # -- statements ---------------------------------------------------------

    def _bind(self, target: ast.expr, derived, value: ast.expr) -> None:
        if not isinstance(target, ast.Name):
            return
        declared = unit_from_name(target.id, self.p.registry)
        if declared is not None and derived not in (None, ANY) \
                and derived != declared:
            self.p.emit("unit-bind-mismatch",
                        f"{self.qual}: '{target.id}' declares "
                        f"'{unit_to_str(declared)}' but is assigned "
                        f"'{unit_to_str(derived)}'", target.lineno)
        elif declared is None and isinstance(value, ast.BinOp) \
                and derived in _INTERESTING:
            self.p.emit("unit-unsuffixed-bind",
                        f"{self.qual}: '{target.id}' binds a derived "
                        f"'{unit_to_str(derived)}' quantity — add the "
                        "unit suffix", target.lineno)
        if derived not in (None, ANY):
            self.env[target.id] = derived
        elif declared is not None:
            self.env[target.id] = declared
        else:
            self.env[target.id] = None

    def visit_Assign(self, node: ast.Assign) -> None:
        derived = self.infer(node.value)
        for t in node.targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    if isinstance(el, ast.Name):
                        self.env[el.id] = unit_from_name(
                            el.id, self.p.registry)
            else:
                self._bind(t, derived, node.value)
        self.generic_visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._bind(node.target, self.infer(node.value), node.value)
            self.generic_visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Name) \
                and isinstance(node.op, (ast.Add, ast.Sub)):
            lu = self.env.get(node.target.id,
                              unit_from_name(node.target.id,
                                             self.p.registry))
            ru = self.infer(node.value)
            self._flag_mismatch(lu, ru, node, "unit-mismatch-add",
                                "+=" if isinstance(node.op, ast.Add)
                                else "-=")
        else:
            self.infer(node.value)
        self.generic_visit(node.value)

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is not None:
            derived = self.infer(node.value)
            if self.declared is not None and derived not in (None, ANY) \
                    and derived != self.declared:
                self.p.emit(
                    "unit-return-mismatch",
                    f"{self.qual}() declares "
                    f"'{unit_to_str(self.declared)}' but returns "
                    f"'{unit_to_str(derived)}'", node.lineno)
            self.generic_visit(node.value)

    def visit_Expr(self, node: ast.Expr) -> None:
        self.infer(node.value)      # compare/min/max checks inside
        self.generic_visit(node.value)

    def visit_If(self, node: ast.If) -> None:
        self.infer(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self.infer(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self.infer(node.test)
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        if node is not self.fn:
            self.p.check_function(node, f"{self.qual}.{node.name}")
        else:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = lambda self, node: None      # noqa: E731 - no units


class _UnitsPass:
    def __init__(self, mod: Module, registry: Dict[str, Unit]):
        self.mod = mod
        self.registry = registry
        self.violations: List[Violation] = []

    def emit(self, rule: str, detail: str, lineno: int) -> None:
        self.violations.append(Violation(
            rule, self.mod.name, detail, lineno, self.mod.path))

    def check_function(self, fn, qual: str) -> None:
        _FnChecker(self, fn, qual).generic_visit(fn)

    def run(self, tree: ast.AST) -> None:
        for node in tree.body:
            self._walk(node, prefix="")

    def _walk(self, node, prefix: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.check_function(node, prefix + node.name)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                self._walk(sub, prefix=f"{node.name}.")


def check_units(modules: Dict[str, Module], root: str,
                policy: dict) -> List[Violation]:
    cfg = policy.get("units")
    if not cfg:
        return []
    registry = {name.lower(): parse_unit_str(u)
                for name, u in cfg.get("names", {}).items()}
    out: List[Violation] = []
    for mod in modules.values():
        if not _match_any(mod.name, cfg.get("modules", [])):
            continue
        tree = parse_module(mod, root)
        if tree is None:
            continue                # reported by the import checker
        p = _UnitsPass(mod, registry)
        p.run(tree)
        out.extend(p.violations)
    return out
