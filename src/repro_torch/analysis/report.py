"""Violations, fingerprints, and the baseline allowlist.

The port's copy of ``repro.analysis.report``, unchanged.

A ``Violation`` is one finding from any checker (import graph,
determinism, hash stability). Its *fingerprint* deliberately excludes
line numbers — ``rule | module | detail`` — so unrelated edits moving a
known-accepted site around the file don't churn the baseline. The
baseline maps fingerprints to accepted occurrence counts; CI fails only
on growth (a new fingerprint, or more occurrences of a baselined one).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str                   # e.g. "forbidden-import", "wallclock"
    module: str                 # dotted module name (or logical target)
    detail: str                 # stable description, no line numbers
    lineno: int = 0             # display only, never in the fingerprint
    path: str = ""              # repo-relative file, display only

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.module}|{self.detail}"

    def format(self) -> str:
        loc = f"{self.path or self.module}"
        if self.lineno:
            loc += f":{self.lineno}"
        return f"{loc}: [{self.rule}] {self.detail}"


@dataclasses.dataclass
class AnalysisResult:
    violations: List[Violation]
    baselined: List[Violation]
    checked_modules: int
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    #   pass name -> elapsed seconds (CI's per-pass timing readout)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        def row(v: Violation) -> dict:
            return {"rule": v.rule, "module": v.module, "detail": v.detail,
                    "path": v.path, "lineno": v.lineno,
                    "fingerprint": v.fingerprint}
        return {
            "ok": self.ok,
            "checked_modules": self.checked_modules,
            "violations": [row(v) for v in self.violations],
            "baselined": [row(v) for v in self.baselined],
            "timings": {k: round(t, 4)
                        for k, t in sorted(self.timings.items())},
        }


def apply_baseline(violations: List[Violation],
                   baseline: Dict[str, int]
                   ) -> "tuple[List[Violation], List[Violation]]":
    """Split findings into (new, accepted). A fingerprint with an accepted
    count of N absorbs its first N occurrences; the rest are new — so the
    check fails on *growth* at a known site, not only on new sites."""
    budget = dict(baseline)
    new: List[Violation] = []
    accepted: List[Violation] = []
    for v in violations:
        if budget.get(v.fingerprint, 0) > 0:
            budget[v.fingerprint] -= 1
            accepted.append(v)
        else:
            new.append(v)
    return new, accepted


def load_baseline(path: Optional[str]) -> Dict[str, int]:
    """Baseline file -> fingerprint -> accepted count. Missing file = empty
    baseline (everything is a new finding)."""
    if path is None:
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    out: Dict[str, int] = {}
    for entry in data.get("accepted", []):
        fp = f"{entry['rule']}|{entry['module']}|{entry['detail']}"
        out[fp] = out.get(fp, 0) + int(entry.get("count", 1))
    return out


def write_baseline(path: str, violations: List[Violation]) -> None:
    """Regenerate the baseline from current findings (sorted, counted) —
    the `--write-baseline` workflow after deliberately accepting a site.
    Existing ``why`` annotations are preserved by fingerprint, so a
    burn-down rewrite doesn't strip the rationale of surviving entries;
    genuinely new fingerprints get a fill-me-in placeholder."""
    whys: Dict[str, str] = {}
    try:
        with open(path) as f:
            for entry in json.load(f).get("accepted", []):
                fp = f"{entry['rule']}|{entry['module']}|{entry['detail']}"
                if entry.get("why"):
                    whys[fp] = entry["why"]
    except (FileNotFoundError, ValueError):
        pass
    counts: Dict[str, Violation] = {}
    tally: Dict[str, int] = {}
    for v in violations:
        counts.setdefault(v.fingerprint, v)
        tally[v.fingerprint] = tally.get(v.fingerprint, 0) + 1
    entries = [{"rule": counts[fp].rule, "module": counts[fp].module,
                "detail": counts[fp].detail, "count": n,
                "why": whys.get(fp, "TODO: annotate why this is accepted")}
               for fp, n in sorted(tally.items())]
    with open(path, "w") as f:
        json.dump({"accepted": entries}, f, indent=1, sort_keys=True)
        f.write("\n")
