"""The readings that a cell's limits are set from: the program's, and the
control's, on the same sample.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 ...

For each seed, in one process: the cell is set up, its mix served for a
ramp and a short window at the cell's own load, and, once the window has
closed and the program's state is freed, a sample of the finished
requests is compared with the plain fp32 reference twice: the tokens the
program served (the program's reading), and at each position of the same
sequences the token that the reference computed in float8 e4m3 puts
first (the control: the nearest precision below the configuration's
bf16). One JSON line per seed with both sets of numbers. The benchmark's
own runs never run the control.
"""
from __future__ import annotations

import time

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    from pbench import cell
    for seed in args.seeds:
        t0 = time.perf_counter()
        bench = cell.Bench(args.workload, seed, t_start=t0, device="cuda",
                           root=ROOT, log=lambda s: None)
        run = bench.serve(bench.mix, args.seconds)
        out = bench.check(run, control=True)
        print(json.dumps({"seed": seed, "program": out["values"],
                          "control": out.get("control"),
                          "served": out["served"],
                          "sampled": out["sampled"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del bench, run, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
