"""Hash-stability check: SweepSpec/SweepCell content addresses are pinned.

The port's copy of ``repro.analysis.hashstab``; it pins the port's own
``repro_torch.sweeps.spec``, whose hashes are the reference's.

The ``SweepStore`` cache-hit contract requires that a grid swept last
month is a full cache hit today: spec and cell hashes must not drift.
New ``SweepSpec``/``SweepCell`` fields are therefore required to
*canonicalize away at their defaults* (the way ``simulate`` /
``sim_requests`` do) so pre-existing shards keep their content
addresses. This check pins, in the policy:

  - the ``spec_hash`` of a small reference grid,
  - the ``cell_id`` of its first expanded cell,
  - the exact canonical key sets of both.

Adding a field without a canonicalize-away default changes the hash
*and* the key set — both are reported, pointing at the fix (mirror the
``simulate`` pattern in ``sweeps/spec.py``) rather than just "hash
changed".
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.report import Violation

_MOD = "repro_torch.sweeps.spec"


def check_hash_stability(policy: dict) -> List[Violation]:
    cfg = policy.get("hash_stability")
    if not cfg:
        return []
    from repro_torch.sweeps.spec import SweepSpec
    out: List[Violation] = []
    spec = SweepSpec.create(**cfg["spec"])

    got = spec.spec_hash()
    if got != cfg["spec_hash"]:
        out.append(Violation(
            "hash-stability", _MOD,
            f"reference SweepSpec hash drifted: {got} != pinned "
            f"{cfg['spec_hash']} — a new field must canonicalize away "
            "at its default (see the simulate/sim_requests pattern)"))
    keys = sorted(spec.canonical())
    if keys != cfg["spec_canonical_keys"]:
        extra = sorted(set(keys) - set(cfg["spec_canonical_keys"]))
        missing = sorted(set(cfg["spec_canonical_keys"]) - set(keys))
        out.append(Violation(
            "hash-stability", _MOD,
            f"SweepSpec canonical keys drifted (extra={extra}, "
            f"missing={missing})"))

    cell = spec.cells()[0]
    got_cell = cell.cell_id()
    if got_cell != cfg["cell_id"]:
        out.append(Violation(
            "hash-stability", _MOD,
            f"reference SweepCell id drifted: {got_cell} != pinned "
            f"{cfg['cell_id']}"))
    ckeys = sorted(cell.canonical())
    if ckeys != cfg["cell_canonical_keys"]:
        extra = sorted(set(ckeys) - set(cfg["cell_canonical_keys"]))
        missing = sorted(set(cfg["cell_canonical_keys"]) - set(ckeys))
        out.append(Violation(
            "hash-stability", _MOD,
            f"SweepCell canonical keys drifted (extra={extra}, "
            f"missing={missing})"))
    return out
