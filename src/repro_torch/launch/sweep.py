"""Design-space sweep launcher (the ``repro_torch.sweeps`` engine CLI).

Declares a grid, runs (or resumes) it against a content-addressed store,
and prints a summary JSON. Reruns over the same grid are cache hits;
interrupted runs resume from completed shards.

  PYTHONPATH=src python -m repro_torch.launch.sweep \
      --models llama-3.1-8b deepseek-r1 \
      --hardware v5e v5p h100 v5p:v5e h100:a100 \
      --isl 512 2048 8192 --osl 64 256 --reuse 0.0 0.5 \
      --modes disagg coloc --max-chips 64 \
      --store .sweeps --workers 4

  # query an existing store without evaluating anything new:
  ... --query best-hardware --weight cost

The port's copy of ``repro.launch.sweep``: the same flags and defaults.
``--models`` takes the paper models and the architecture ids of the
port's registry (``repro_torch.configs``).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.hardware import CHIP_NAMES
from repro_torch.sweeps import SweepResult, SweepSpec, SweepStore, run_sweep
from repro_torch.sweeps.spec import MODES


def build_spec(args) -> SweepSpec:
    return SweepSpec.create(
        models=args.models, hardware=args.hardware, isl=args.isl,
        osl=args.osl, reuse=args.reuse, modes=args.modes,
        ttl_targets=args.ttl_targets, ftl_cutoff=args.ftl_cutoff,
        max_chips=args.max_chips, simulate=args.simulate,
        sim_requests=args.sim_requests)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="vectorized, resumable design-space sweeps")
    ap.add_argument("--models", nargs="+", default=["llama-3.1-8b"],
                    help="paper model names (deepseek-r1, llama-3.1-8b/"
                    "70b/405b) or assigned-arch ids from repro_torch.configs")
    ap.add_argument("--hardware", nargs="+", default=["v5e"],
                    help=f"chips ({', '.join(CHIP_NAMES)}) or hetero "
                    "prefill:decode pairs like v5p:v5e")
    ap.add_argument("--isl", nargs="+", type=int, default=[2048])
    ap.add_argument("--osl", nargs="+", type=int, default=[256])
    ap.add_argument("--reuse", nargs="+", type=float, default=[0.0],
                    help="KV reuse fractions in [0, 1)")
    ap.add_argument("--modes", nargs="+", choices=MODES,
                    default=["disagg"])
    ap.add_argument("--ttl-targets", type=int, default=24)
    ap.add_argument("--ftl-cutoff", type=float, default=10.0)
    ap.add_argument("--max-chips", type=int, default=None)
    ap.add_argument("--simulate", action="store_true",
                    help="run a bounded Cluster.serve episode on the "
                    "SimEngine backend per cell (sla_metrics columns next "
                    "to the analytic records)")
    ap.add_argument("--sim-requests", type=int, default=24,
                    help="requests per simulated episode (--simulate)")
    ap.add_argument("--store", default=".sweeps",
                    help="store root directory (content-addressed)")
    ap.add_argument("--format", choices=["jsonl", "parquet"],
                    default="jsonl")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes (0 = inline)")
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate at most N pending cells this run")
    ap.add_argument("--no-resume", action="store_true",
                    help="recompute every cell even if its shard exists")
    ap.add_argument("--query", choices=["frontier", "best-hardware",
                                        "sensitivity", "sim-delta"],
                    default=None,
                    help="after the run, print this query instead of the "
                    "run report")
    ap.add_argument("--weight", choices=["chip", "cost"], default="chip")
    ap.add_argument("--axis", default="isl",
                    help="axis for --query sensitivity")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    store = SweepStore(args.store, fmt=args.format)
    log = None if args.quiet else (lambda s: print(s, file=sys.stderr))
    report = run_sweep(spec, store, workers=args.workers, limit=args.limit,
                       resume=not args.no_resume, log=log)

    if args.query:
        res = SweepResult(store, spec)
        if args.query == "frontier":
            out = {"frontier": res.frontier(weight=args.weight)}
        elif args.query == "best-hardware":
            out = {"best_hardware": [
                {"prefill": p, "decode": d, "area": a}
                for (p, d), a in res.best_hardware(weight=args.weight)]}
        elif args.query == "sim-delta":
            out = {"sim_delta": res.sim_delta(weight=args.weight)}
        else:
            out = {"sensitivity": res.sensitivity(args.axis,
                                                  weight=args.weight)}
        out["spec_hash"] = spec.spec_hash()
        out["weight"] = args.weight
        print(json.dumps(out, indent=1))
        return out
    print(json.dumps(report.to_json(), indent=1))
    return report


if __name__ == "__main__":
    main()
