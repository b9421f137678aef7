"""Plugin-contract conformance: the policy seams, machine-checked.

The port's copy of ``repro.analysis.contracts``. Its framework list adds
``torch``: the port's serving runtime is torch-free as the reference's is
jax-free, and a finding names whichever framework it caught.

The ROADMAP invariant says new scenarios are ``SchedulerPolicy`` /
``Router`` / ``RateMatcher`` plugins on ``Cluster`` and new traffic is a
``Workload`` — but until now the contracts those plugins must honor
were enforced only by convention. This pass:

  1. **discovers** every implementation repo-wide (including ``tests/``
     and ``examples/``): a non-Protocol class providing all of a
     protocol's methods, directly or through its base chain;
  2. **checks signatures** exactly against the Protocol class ASTs
     (param names and order; extra trailing params need defaults;
     ``*args/**kwargs`` are flagged — the Cluster calls these hooks
     positionally);
  3. **enforces purity**: policy hooks observe the cluster and *return*
     decisions — they must not mutate ``Cluster``/``Engine`` state
     outside the approved mutation API (``mutation_allow`` in
     ``policy.json``: ``cluster.migrate`` / ``cluster.requeue_inflight``
     / ``cluster.retire`` anywhere; engine prefill/decode entry points
     inside ``run_prefill``), must not read the wall clock or global rng
     (the ``determinism.py`` detectors, scoped to hook bodies — both
     backends replay schedules, so a wall-clock read desyncs them), and
     must not import jax or torch (the serving runtime is free of
     both).

The runtime twin is the sanitizer's policy-purity guard
(``ClusterSanitizer.state_digest`` / ``check_hook_purity``), which hashes
cluster-visible state around each ``select``/``route`` call under
``REPRO_SANITIZE=1`` — this pass catches the mutation statically, the
guard catches mutation laundered through calls the AST can't see.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.determinism import _DetVisitor
from repro_torch.analysis.imports import Module, _match_any, parse_module
from repro_torch.analysis.report import Violation

# attribute leaves that mutate their receiver (containers + the Cluster /
# Engine / AdmissionQueue mutation surface)
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "sort", "reverse", "update", "setdefault", "add", "discard",
    "push_front", "evict", "fail", "slow_down", "reset_for_requeue",
    "prefill", "prefill_chunked", "decode_step", "decode_round",
    "migrate", "requeue_inflight", "retire", "serve", "run", "_step",
    "_fail_engine", "_invalidate_views",
}
_JAX_PKGS = ("jax", "jaxlib", "flax", "optax", "torch")
_DET_RULES = ("wallclock", "global-rng", "unseeded-rng")

RULES = {
    "contract-signature": (
        "the Cluster event loop calls plugin hooks positionally with an "
        "exact arity; a drifted signature fails at serve time (or worse, "
        "binds the wrong argument to the wrong name)",
        "match the Protocol signature exactly; give any extra "
        "configuration params defaults"),
    "contract-mutation": (
        "policy hooks observe and decide — the event loop owns all "
        "state transitions; a hook that mutates pools/queues/engines "
        "directly corrupts cached views and breaks schedule parity "
        "between backends",
        "return the decision and let the Cluster act, or use the "
        "approved mutation API (cluster.migrate / requeue_inflight / "
        "retire)"),
    "contract-wallclock": (
        "both backends must replay identical schedules; a policy that "
        "reads wall time decides differently on every run",
        "derive timing decisions from cluster.now (virtual time)"),
    "contract-global-rng": (
        "a policy drawing from the process-wide rng makes schedule "
        "replay depend on unrelated code's draw order",
        "take a seeded np.random.Generator in the policy constructor"),
    "contract-unseeded-rng": (
        "an unseeded generator varies per process; schedules stop being "
        "reproducible",
        "seed the generator from explicit configuration"),
    "contract-jax-import": (
        "the serving runtime is jax-free and torch-free (ROADMAP "
        "invariant): sim sweep workers fork cheaply only because policies "
        "never pay a framework import",
        "keep accelerator work inside Engine; policies do bookkeeping "
        "only"),
}


@dataclasses.dataclass
class _Proto:
    name: str
    module: str
    # method -> (param names after self, number of trailing defaults)
    methods: Dict[str, List[str]]


@dataclasses.dataclass
class _Cls:
    name: str
    module: Module
    node: ast.ClassDef
    bases: List[str]
    methods: Dict[str, ast.FunctionDef]     # defined directly

    @property
    def qual(self) -> str:
        return f"{self.module.name}.{self.name}"


def _method_params(fn: ast.FunctionDef) -> Tuple[List[str], int, bool]:
    """(param names after self, count with defaults, has star args)."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    star = a.vararg is not None or a.kwarg is not None
    return names, len(a.defaults), star


def _collect_protocols(modules: Dict[str, Module], root: str,
                       cfg: dict) -> List[_Proto]:
    out: List[_Proto] = []
    wanted = set(cfg.get("protocols", []))
    for mname in cfg.get("protocol_modules", []):
        mod = modules.get(mname)
        if mod is None:
            continue
        tree = parse_module(mod, root)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) or node.name not in wanted:
                continue
            methods: Dict[str, List[str]] = {}
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and not item.name.startswith("_"):
                    methods[item.name] = _method_params(item)[0]
            if methods:
                out.append(_Proto(node.name, mname, methods))
    return out


def _collect_classes(modules: Dict[str, Module], root: str,
                     exempt: List[str]) -> List[_Cls]:
    out: List[_Cls] = []
    for mod in modules.values():
        if _match_any(mod.name, exempt):
            continue
        tree = parse_module(mod, root)
        if tree is None:
            continue
        for node in tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            bases = []
            for b in node.bases:
                if isinstance(b, ast.Name):
                    bases.append(b.id)
                elif isinstance(b, ast.Attribute):
                    bases.append(b.attr)
            methods = {i.name: i for i in node.body
                       if isinstance(i, ast.FunctionDef)}
            out.append(_Cls(node.name, mod, node, bases, methods))
    return out


def _method_set(cls: _Cls, by_name: Dict[str, _Cls],
                seen: Optional[Set[str]] = None) -> Set[str]:
    """All method names, following the base chain by class name."""
    seen = seen or set()
    if cls.name in seen:
        return set()
    seen.add(cls.name)
    out = set(cls.methods)
    for b in cls.bases:
        base = by_name.get(b)
        if base is not None:
            out |= _method_set(base, by_name, seen)
    return out


class _PurityVisitor(ast.NodeVisitor):
    """Flags mutations of protected (cluster/engine) state in one hook."""

    def __init__(self, protected: Set[str], allowed: Set[str],
                 emit, qual: str):
        self.aliases = set(protected)
        self.allowed = allowed
        self.emit = emit
        self.qual = qual

    def _root(self, node: ast.expr) -> str:
        """Base Name of an attribute/subscript/call chain ('' if none)."""
        while True:
            if isinstance(node, ast.Attribute):
                node = node.value
            elif isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call):
                node = node.func
            elif isinstance(node, ast.Name):
                return node.id
            else:
                return ""

    def _protected(self, node: ast.expr) -> bool:
        return self._root(node) in self.aliases

    def _snip(self, node) -> str:
        try:
            s = ast.unparse(node)
        except Exception:           # pragma: no cover - unparse is total
            return "<stmt>"
        return s if len(s) <= 60 else s[:57] + "..."

    def _mutation(self, node, what: str) -> None:
        self.emit("contract-mutation",
                  f"{self.qual} mutates cluster-visible state outside "
                  f"the approved API: {what} ({self._snip(node)})",
                  node.lineno)

    def _maybe_alias(self, target: ast.expr, value: ast.expr) -> None:
        if isinstance(target, ast.Name) \
                and isinstance(value, (ast.Attribute, ast.Subscript)) \
                and self._protected(value):
            self.aliases.add(target.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)) \
                    and self._protected(t):
                self._mutation(node, "attribute/item assignment")
            elif isinstance(t, (ast.Tuple, ast.List)) \
                    and isinstance(node.value, (ast.Tuple, ast.List)) \
                    and len(t.elts) == len(node.value.elts):
                for el, val in zip(t.elts, node.value.elts):
                    self._maybe_alias(el, val)
                    if isinstance(el, (ast.Attribute, ast.Subscript)) \
                            and self._protected(el):
                        self._mutation(node, "attribute/item assignment")
            else:
                self._maybe_alias(t, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, (ast.Attribute, ast.Subscript)) \
                and self._protected(node.target):
            self._mutation(node, "augmented assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)) \
                    and self._protected(t):
                self._mutation(node, "del")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        # `for pool in (cluster.prefill_pool, cluster.decode_pool)` and
        # `for e in cluster.engines()`: the loop variable is cluster state
        iters = (node.iter.elts
                 if isinstance(node.iter, (ast.Tuple, ast.List))
                 else [node.iter])
        if any(self._protected(i) for i in iters):
            targets = (node.target.elts
                       if isinstance(node.target, (ast.Tuple, ast.List))
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    self.aliases.add(t.id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS \
                and node.func.attr not in self.allowed \
                and self._protected(node.func.value):
            self._mutation(node, f"call to .{node.func.attr}()")
        elif isinstance(node.func, ast.Name) \
                and node.func.id in ("setattr", "delattr") and node.args \
                and self._protected(node.args[0]):
            self._mutation(node, f"{node.func.id}()")
        self.generic_visit(node)


def check_contracts(modules: Dict[str, Module], root: str,
                    policy: dict) -> List[Violation]:
    cfg = policy.get("contracts")
    if not cfg:
        return []
    protos = _collect_protocols(modules, root, cfg)
    if not protos:
        return []
    exempt = list(cfg.get("exempt", []))
    classes = _collect_classes(modules, root, exempt)
    by_name: Dict[str, _Cls] = {}
    for c in classes:
        by_name.setdefault(c.name, c)
    proto_names = {p.name for p in protos}
    purity_protos = set(cfg.get("purity", []))
    protected_params = set(cfg.get("protected_params", []))
    allow_cfg = cfg.get("mutation_allow", {})
    out: List[Violation] = []

    def emit_for(cls: _Cls):
        def emit(rule: str, detail: str, lineno: int) -> None:
            out.append(Violation(rule, cls.module.name, detail, lineno,
                                 cls.module.path))
        return emit

    impl_methods_by_module: Dict[str, List[Tuple[int, int, str]]] = {}
    impl_modules: Dict[str, Module] = {}

    for cls in classes:
        if cls.name in proto_names or "Protocol" in cls.bases:
            continue
        names = _method_set(cls, by_name)
        matched = [p for p in protos if set(p.methods) <= names]
        if not matched:
            continue
        emit = emit_for(cls)
        impl_modules[cls.module.name] = cls.module
        spans = impl_methods_by_module.setdefault(cls.module.name, [])
        for fn in cls.methods.values():
            spans.append((fn.lineno, fn.end_lineno or fn.lineno,
                          f"{cls.qual}.{fn.name}"))

        purity = any(p.name in purity_protos for p in matched)
        for proto in matched:
            for mname, want in proto.methods.items():
                fn = cls.methods.get(mname)
                if fn is None:
                    continue        # inherited: checked on the base class
                got, n_defaults, star = _method_params(fn)
                extra = got[len(want):]
                ok = (got[:len(want)] == want and not star
                      and len(extra) <= n_defaults)
                if not ok:
                    emit("contract-signature",
                         f"{cls.qual}.{mname}({', '.join(got)}"
                         f"{', *...' if star else ''}) does not match "
                         f"{proto.name}.{mname}({', '.join(want)}) — "
                         "extra params need defaults", fn.lineno)
        if purity:
            allowed_any = set(allow_cfg.get("*", []))
            for mname, fn in cls.methods.items():
                allowed = allowed_any | set(allow_cfg.get(mname, []))
                params, _, _ = _method_params(fn)
                prot = {p for p in params if p in protected_params}
                # helpers see protected state through their own params
                if not prot:
                    continue
                v = _PurityVisitor(prot, allowed, emit,
                                   f"{cls.qual}.{mname}")
                for stmt in fn.body:
                    v.visit(stmt)

    # determinism + framework rules, scoped to implementation method bodies
    for mname, spans in sorted(impl_methods_by_module.items()):
        mod = impl_modules[mname]
        tree = parse_module(mod, root)
        if tree is None:
            continue
        det = _DetVisitor(mod, list(_DET_RULES))
        det.visit(tree)

        def _owner(lineno: int) -> Optional[str]:
            for lo, hi, qual in spans:
                if lo <= lineno <= hi:
                    return qual
            return None

        for v in det.violations:
            qual = _owner(v.lineno)
            if qual is not None:
                out.append(Violation(f"contract-{v.rule}", mod.name,
                                     f"{qual}: {v.detail}", v.lineno,
                                     mod.path))
        for e in mod.edges:
            if not any(e.imported == p or e.imported.startswith(p + ".")
                       for p in _JAX_PKGS):
                continue
            free = "torch" if e.imported.split(".")[0] == "torch" else "jax"
            where = _owner(e.lineno)
            if where is not None:
                out.append(Violation(
                    "contract-jax-import", mod.name,
                    f"{where} imports {e.imported!r} inside a policy "
                    f"hook (the serving runtime is {free}-free)",
                    e.lineno, mod.path))
            elif e.kind == "eager":
                out.append(Violation(
                    "contract-jax-import", mod.name,
                    f"module defining plugin implementations eagerly "
                    f"imports {e.imported!r} (the serving runtime is "
                    f"{free}-free)", e.lineno, mod.path))
    return out
