"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: loads the cell's configuration, mix and
deployment (``portbench/{configs,traffic,cells}``), draws the weights and
the traffic from ``--seed``, sets up and ramps the load, measures for
``--seconds`` on the wall clock, checks the served tokens against the
plain fp32 reference, and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; then ``checks``, each compared number beside
its limit, which also close standard error.

It exits non-zero with no result where the card is missing, where the
program (``src/repro_torch``) is not in the checkout, and where the JAX
package or JAX itself was loaded into this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def fail(code: int, why: str):
    print(f"portbench: {why}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail(2, f"{ROOT / 'src' / 'repro_torch'} not found: run from a "
                "checkout that holds the program")
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from pbench import cell, spec, trace
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != (
            ROOT / "src" / "repro_torch").resolve():
        fail(2, f"repro_torch loaded from {repro_torch.__file__}, not from "
                "this checkout")
    b = spec.load(ROOT / "BENCHMARK.json")
    entry = spec.cell_entry(b, args.workload)
    if not torch.cuda.is_available():
        fail(3, "no CUDA device")
    if torch.cuda.device_count() < entry["chips"]:
        fail(3, f"{torch.cuda.device_count()} CUDA devices, the cell "
                f"needs {entry['chips']}")

    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, device="cuda", root=ROOT)
    run = out.pop("_run")
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(b, args.workload, kind):
        read, variant = spec.reader(m["name"], ROOT)
        v = read(run, variant)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": entry["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace and run.td is not None:
        dev["busy_s"] = run.td.busy_s
        dev["window_s"] = run.td.window_s
        result["breakdown"] = trace.breakdown(run.td)
    checks = {k: {"value": cell.finite(float(r["value"])),
                  "limit": r["limit"]} for k, r in out["checks"].items()}
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        fail(4, "the run loaded " + ", ".join(found)
             + " (JAX or the JAX package)")
    for k, r in checks.items():
        print(f"check {k}: {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
