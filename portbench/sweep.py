"""Find a paced cell's knee: the highest Poisson rate at which the queue
does not grow through a window.

    python3 portbench/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates 4 5 6 7

One process sets the cell up once and serves its mix at each rate in
turn (each a fresh episode: ramp, then window). For each rate it prints
one JSON line: the requests released and still waiting for a prefill at
the window's end (the backlog), the first and second half's 90th
percentile of time to first token, and the tokens a second. The queue
grows where the backlog keeps rising and the second half's tail
exceeds the first's. The cell's rate (0.8 of the knee) goes into its
traffic file by hand; the benchmark's runs never call this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from pbench import cell, wall
    bench = cell.Bench(args.workload, args.seed, t_start=T_START,
                       device="cuda", root=ROOT)
    for rate in args.rates:
        mix = copy.deepcopy(bench.mix)
        mix["arrivals"]["rate"] = rate
        run = bench.serve(mix, args.seconds)
        half = run.w0 + 0.5 * (run.w1 - run.w0)
        first = [s.first - s.due for s in run.stamps
                 if s.first is not None and run.w0 <= s.first < half]
        second = [s.first - s.due for s in run.stamps
                  if s.first is not None and half <= s.first <= run.w1]
        print(json.dumps({
            "rate": rate, "released": run.released, "backlog": run.backlog,
            "ttft_p90_first_half": wall.percentile(first, 90),
            "ttft_p90_second_half": wall.percentile(second, 90),
            "itl_p90_s": wall.percentile(wall.itl(run), 90),
            "output_tokens_per_s": wall.tokens_in_window(run)
            / (run.w1 - run.w0),
            "decode_steps": len(run.window_decodes()),
            "prefills": len(run.window_prefills())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
