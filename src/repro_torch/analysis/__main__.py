"""CLI: ``python -m repro_torch.analysis [--json]``, the port of
``repro.analysis.__main__``.

Runs six passes over the repo — import layering, determinism,
dimensional consistency (units), plugin contracts, hot-path complexity,
and hash stability — subtracts the baseline, and exits non-zero iff
*new* violations remain:

  python -m repro_torch.analysis                   # human-readable report
  python -m repro_torch.analysis --json            # machine-readable
  python -m repro_torch.analysis --write-baseline  # accept current findings
  python -m repro_torch.analysis --explain <rule>  # why a rule exists + fix
  python -m repro_torch.analysis --files a.py b.py # only findings in these
  #                                                  files

Policy and baseline default to the port's own checked-in files next to
this module (``policy.json`` / ``baseline.json``); ``--root``
(repeatable) / ``--policy``/``--baseline`` retarget everything, which is
how the self-tests run the suite against deliberately broken fixture
trees. It runs no tensor, so it takes no ``--device``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.analysis import contracts, hotpath, units
from repro_torch.analysis.determinism import check_determinism
from repro_torch.analysis.hashstab import check_hash_stability
from repro_torch.analysis.imports import check_imports, scan_modules
from repro_torch.analysis.report import (AnalysisResult, Violation,
                                         apply_baseline, load_baseline,
                                         write_baseline)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_POLICY = os.path.join(_PKG_DIR, "policy.json")
DEFAULT_BASELINE = os.path.join(_PKG_DIR, "baseline.json")

# rule name -> (rationale, suggested fix), for --explain. The pass
# modules own their tables; CLI-level rules are registered here.
EXPLAIN: Dict[str, tuple] = {
    "syntax-error": (
        "an unparseable file is invisible to every other pass — the "
        "analysis would silently skip it",
        "fix the syntax error"),
    "forbidden-import": (
        "the layering policy (policy.json import_rules) forbids this "
        "edge; each rule entry carries its own reason",
        "drop the import, or make it lazy/TYPE_CHECKING if the rule "
        "allows those"),
    "forbidden-import-transitive": (
        "the module eagerly reaches a forbidden package through its "
        "import closure, which is as costly as importing it directly",
        "make the first edge of the chain lazy"),
    "hash-stability": (
        "SweepSpec/SweepCell hashes name persisted artifacts; silent "
        "drift orphans every stored shard",
        "if the change is intentional, re-pin the hashes in policy.json "
        "and regenerate the goldens"),
    "unseeded-rng": (
        "np.random.default_rng() with no seed varies per process; "
        "serialized artifacts and sim schedules stop being reproducible",
        "thread an explicit seed from configuration"),
    "global-rng": (
        "the process-wide numpy/random state makes results depend on "
        "unrelated code's draw order",
        "use a local np.random.Generator(seed)"),
    "wallclock": (
        "wall-clock reads leak host timing into serialized or simulated "
        "results",
        "use virtual time (cluster.now) or take timestamps as inputs"),
    "set-order": (
        "iterating a set (hash order) into a serialized artifact varies "
        "across runs and hosts (PYTHONHASHSEED)",
        "sort before iterating"),
    "json-sort-keys": (
        "json.dump without sort_keys=True serializes dict insertion "
        "order — not byte-stable across code refactors",
        "pass sort_keys=True"),
    "float-sum": (
        "builtin sum() over floats is order-sensitive; frontier areas "
        "are compared at tight tolerances",
        "use math.fsum"),
}
EXPLAIN.update(units.RULES)
EXPLAIN.update(contracts.RULES)
EXPLAIN.update(hotpath.RULES)


def default_root() -> str:
    # src/repro_torch/analysis -> repo root is three levels up
    return os.path.abspath(os.path.join(_PKG_DIR, "..", "..", ".."))


def run_analysis(root: Union[str, Sequence[str]], policy: dict,
                 baseline: Optional[dict] = None,
                 files: Optional[Sequence[str]] = None) -> AnalysisResult:
    """The whole suite as a library call (tests drive this directly).

    ``root`` may be one path or a list (findings merge across trees;
    module names collide last-wins, so disjoint trees are the intended
    use). ``files`` restricts the scan to those paths — the fast
    changed-files mode; hash stability (whole-repo by nature)
    is skipped when filtering.
    """
    roots = [root] if isinstance(root, str) else list(root)
    primary = roots[0]
    modules = {}
    for r in roots:
        modules.update(scan_modules(r, policy.get("roots", ["src"])))
    if files is not None:
        wanted = {os.path.abspath(f) for f in files}
        modules = {name: m for name, m in modules.items()
                   if m.abspath in wanted}
    violations: List[Violation] = []
    timings: Dict[str, float] = {}
    passes = [
        ("imports", lambda: check_imports(
            modules, policy.get("import_rules", []))),
        ("determinism", lambda: check_determinism(
            modules, primary, policy.get("determinism", []))),
        ("units", lambda: units.check_units(modules, primary, policy)),
        ("contracts", lambda: contracts.check_contracts(
            modules, primary, policy)),
        ("hotpath", lambda: hotpath.check_hotpath(
            modules, primary, policy)),
        ("hashstab", lambda: [] if files is not None
            else check_hash_stability(policy)),
    ]
    for name, run in passes:
        t0 = time.perf_counter()
        violations += run()
        timings[name] = time.perf_counter() - t0
    violations.sort(key=lambda v: (v.path, v.lineno, v.rule, v.detail))
    new, accepted = apply_baseline(violations, baseline or {})
    return AnalysisResult(violations=new, baselined=accepted,
                          checked_modules=len(modules), timings=timings)


def explain(rule: str) -> int:
    info = EXPLAIN.get(rule)
    if info is None:
        known = ", ".join(sorted(EXPLAIN))
        print(f"unknown rule {rule!r}; known rules: {known}")
        return 2
    why, fix = info
    print(f"{rule}\n  why: {why}\n  fix: {fix}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="architecture, determinism, units, contract, and "
                    "hot-path static analysis")
    ap.add_argument("--root", action="append", default=None,
                    help="repo root containing the source roots "
                         "(repeatable; findings merge)")
    ap.add_argument("--policy", default=DEFAULT_POLICY,
                    help="layering/determinism/units/contracts policy JSON")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="accepted-findings baseline JSON")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into --baseline")
    ap.add_argument("--files", nargs="+", default=None, metavar="PATH",
                    help="only analyze these files")
    ap.add_argument("--explain", default=None, metavar="RULE",
                    help="print a rule's rationale and suggested fix")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--timings", action="store_true",
                    help="print per-pass wall time")
    args = ap.parse_args(argv)

    if args.explain is not None:
        return explain(args.explain)

    with open(args.policy) as f:
        policy = json.load(f)
    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    roots = args.root if args.root else [default_root()]
    result = run_analysis(roots, policy, baseline, files=args.files)

    if args.write_baseline:
        write_baseline(args.baseline,
                       result.violations + result.baselined)
        print(f"wrote {len(result.violations) + len(result.baselined)} "
              f"accepted finding(s) to {args.baseline}")
        return 0

    if args.as_json:
        print(json.dumps(result.to_json(), indent=1, sort_keys=True))
    else:
        for v in result.violations:
            print(v.format())
        if args.timings:
            for name, t in result.timings.items():
                print(f"  pass {name:<12} {t * 1e3:8.1f} ms")
        print(f"repro_torch.analysis: {result.checked_modules} modules "
              f"checked, {len(result.violations)} new violation(s), "
              f"{len(result.baselined)} baselined")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
