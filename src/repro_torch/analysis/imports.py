"""AST import-graph checker: layering rules over ``src/repro_torch``.

The port's copy of ``repro.analysis.imports``, unchanged.

Walks every module under the configured roots, records each import edge
with its *kind* — ``eager`` (module scope), ``lazy`` (inside a function
body), or ``type_checking`` (under an ``if TYPE_CHECKING:`` block) — and
enforces the rules declared in the checked-in policy:

  {"name": "serving-runtime-torch-free",
   "modules": ["repro_torch.serving.cluster", "repro_torch.workloads.*",
               ...],
   "forbid": ["torch", "jax"],
   "allow": ["type_checking", "lazy"],
   "transitive": true}

``forbid`` entries match the imported name by dotted prefix ("torch"
forbids "torch.nn"). ``allow`` lists import kinds exempt from the rule
(``eager`` can never be allowed — that would void the rule).
``transitive`` additionally follows *eager* repo-internal edges, so a
protected module can't launder a forbidden import through a helper; the
violation names the chain.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.report import Violation

KINDS = ("eager", "lazy", "type_checking")


@dataclasses.dataclass(frozen=True)
class ImportEdge:
    imported: str               # dotted name as written (resolved relative)
    kind: str                   # eager | lazy | type_checking
    lineno: int


@dataclasses.dataclass
class Module:
    name: str                   # dotted module name
    path: str                   # repo-relative file path
    edges: List[ImportEdge]
    abspath: str = ""           # absolute path (multi-root scans re-open
    #                             sources through this, not root+path)


def _is_type_checking_test(test: ast.expr) -> bool:
    """Matches ``if TYPE_CHECKING:`` / ``if typing.TYPE_CHECKING:``."""
    if isinstance(test, ast.Name):
        return test.id == "TYPE_CHECKING"
    if isinstance(test, ast.Attribute):
        return test.attr == "TYPE_CHECKING"
    return False


class _ImportVisitor(ast.NodeVisitor):
    def __init__(self, package: str):
        self.package = package      # for resolving relative imports
        self.edges: List[ImportEdge] = []
        self._fn_depth = 0
        self._tc_depth = 0

    def _kind(self) -> str:
        if self._tc_depth:
            return "type_checking"
        if self._fn_depth:
            return "lazy"
        return "eager"

    def _add(self, name: str, lineno: int) -> None:
        if name and name != "__future__":
            self.edges.append(ImportEdge(name, self._kind(), lineno))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._add(alias.name, node.lineno)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:                          # relative import
            parts = self.package.split(".")
            parts = parts[: len(parts) - (node.level - 1)]
            base = ".".join(parts + ([base] if base else []))
        # `from pkg import name` may bind a submodule: record both the
        # base and the dotted candidates; rule matching is prefix-based,
        # and the graph resolver keeps whichever exists on disk.
        self._add(base, node.lineno)
        for alias in node.names:
            if alias.name != "*":
                self._add(f"{base}.{alias.name}" if base else alias.name,
                          node.lineno)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    def visit_If(self, node: ast.If) -> None:
        if _is_type_checking_test(node.test):
            self._tc_depth += 1
            for stmt in node.body:
                self.visit(stmt)
            self._tc_depth -= 1
            for stmt in node.orelse:
                self.visit(stmt)
        else:
            self.generic_visit(node)


def module_name(root: str, path: str, src_prefix: str) -> str:
    """Dotted module name for a file under ``<root>/<src_prefix>``.

    A root named ``src`` (or ``src/...``) is a *package* root: its prefix
    vanishes (``src/repro_torch/core/x.py`` -> ``repro_torch.core.x``).
    Any other root (``tests``) is a *directory* of loose modules: the
    root's own path becomes the name prefix (``tests/test_torch_sim.py``
    -> ``tests.test_torch_sim``), so policy patterns can target them
    without colliding with packages."""
    rel = os.path.relpath(path, os.path.join(root, src_prefix))
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    prefix_parts = [p for p in src_prefix.replace("\\", "/").split("/") if p]
    if prefix_parts and prefix_parts[0] != "src":
        parts = prefix_parts + parts
    return ".".join(p for p in parts if p)


def scan_modules(root: str, src_roots: Iterable[str]) -> Dict[str, Module]:
    """Parse every ``.py`` under ``<root>/<src_root>`` into the import
    graph. Unparseable files surface as a module with a single
    ``syntax-error`` pseudo-edge (reported by check_imports)."""
    out: Dict[str, Module] = {}
    for src in src_roots:
        base = os.path.join(root, src)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                name = module_name(root, path, src)
                pkg = name if fn == "__init__.py" \
                    else name.rsplit(".", 1)[0] if "." in name else ""
                with open(path, encoding="utf-8") as f:
                    text = f.read()
                rel = os.path.relpath(path, root)
                try:
                    tree = ast.parse(text, filename=path)
                except SyntaxError as e:
                    out[name] = Module(name, rel, [ImportEdge(
                        f"<syntax error: {e.msg}>", "eager",
                        e.lineno or 0)], os.path.abspath(path))
                    continue
                v = _ImportVisitor(pkg)
                v.visit(tree)
                out[name] = Module(name, rel, v.edges,
                                   os.path.abspath(path))
    return out


def _match_any(name: str, patterns: Iterable[str]) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in patterns)


def module_path(mod: Module, root: str) -> str:
    """Filesystem path of a scanned module (multi-root scans carry their
    own absolute path; single-root callers may still pass a bare root)."""
    return mod.abspath or os.path.join(root, mod.path)


def parse_module(mod: Module, root: str) -> Optional[ast.AST]:
    """Re-parse a scanned module for a follow-on AST pass; None on syntax
    errors (already reported by check_imports)."""
    with open(module_path(mod, root), encoding="utf-8") as f:
        try:
            return ast.parse(f.read(), filename=mod.path)
        except SyntaxError:
            return None


def _forbidden(imported: str, forbid: Iterable[str]) -> bool:
    return any(imported == f or imported.startswith(f + ".")
               for f in forbid)


def _resolve_internal(imported: str, modules: Dict[str, Module]
                      ) -> Optional[str]:
    """Map an imported dotted name to the repo module that provides it
    (longest prefix wins: ``repro_torch.sweeps.spec.SweepSpec`` -> the
    module)."""
    name = imported
    while name:
        if name in modules:
            return name
        name = name.rsplit(".", 1)[0] if "." in name else ""
    return None


def _eager_internal_edges(modules: Dict[str, Module]
                          ) -> Dict[str, List[Tuple[str, int]]]:
    out: Dict[str, List[Tuple[str, int]]] = {}
    for mod in modules.values():
        seen = set()
        dst_list = out.setdefault(mod.name, [])
        for e in mod.edges:
            if e.kind != "eager":
                continue
            dst = _resolve_internal(e.imported, modules)
            if dst and dst != mod.name and dst not in seen:
                seen.add(dst)
                dst_list.append((dst, e.lineno))
    return out


def check_imports(modules: Dict[str, Module],
                  rules: List[dict]) -> List[Violation]:
    violations: List[Violation] = []
    # broken parses fail loudly whatever the policy says
    for mod in modules.values():
        for e in mod.edges:
            if e.imported.startswith("<syntax error"):
                violations.append(Violation(
                    "syntax-error", mod.name, e.imported.strip("<>"),
                    e.lineno, mod.path))
    eager_graph = None
    for rule in rules:
        allow = set(rule.get("allow", ("type_checking",)))
        assert "eager" not in allow, \
            f"rule {rule.get('name')!r} allows eager imports: vacuous"
        forbid = rule["forbid"]
        targets = [m for m in modules.values()
                   if _match_any(m.name, rule["modules"])]
        for mod in targets:
            # one `from X import a, b` line records X plus X.a / X.b; a
            # single violation per (line, kind) names the shortest match
            hits: Dict[Tuple[int, str], str] = {}
            for e in mod.edges:
                if e.kind in allow or not _forbidden(e.imported, forbid):
                    continue
                key = (e.lineno, e.kind)
                if key not in hits or len(e.imported) < len(hits[key]):
                    hits[key] = e.imported
            for (lineno, kind), imported in sorted(hits.items()):
                violations.append(Violation(
                    "forbidden-import", mod.name,
                    f"[{rule['name']}] imports {imported!r} "
                    f"({kind})", lineno, mod.path))
        if not rule.get("transitive"):
            continue
        if eager_graph is None:
            eager_graph = _eager_internal_edges(modules)
        for mod in targets:
            chain = _find_transitive(mod.name, forbid, modules, eager_graph)
            # chain = [mod, helper..., forbidden]; length 2 is a direct
            # import, already reported above
            if chain and len(chain) >= 3:
                path_str = " -> ".join(chain[:-1]) + f" -> {chain[-1]}"
                violations.append(Violation(
                    "forbidden-import-transitive", mod.name,
                    f"[{rule['name']}] eagerly reaches {chain[-1]!r} "
                    f"via {path_str}", 0, mod.path))
    return violations


def _find_transitive(start: str, forbid: Iterable[str],
                     modules: Dict[str, Module],
                     eager_graph: Dict[str, List[Tuple[str, int]]]
                     ) -> Optional[List[str]]:
    """BFS over eager repo-internal edges from ``start``; returns the
    shortest chain ``[start, ..., helper, forbidden_import]`` whose last
    hop is a forbidden *eager* external import, else None."""
    from collections import deque
    parent: Dict[str, Optional[str]] = {start: None}
    q = deque([start])
    while q:
        cur = q.popleft()
        for e in modules[cur].edges:
            if e.kind == "eager" and _forbidden(e.imported, forbid):
                chain = [e.imported]
                node: Optional[str] = cur
                while node is not None:
                    chain.append(node)
                    node = parent[node]
                return list(reversed(chain))
        for dst, _ in eager_graph.get(cur, ()):
            if dst not in parent:
                parent[dst] = cur
                q.append(dst)
    return None
