"""Disaggregated serving launcher of the port.

Runs the model through the policy-driven ``Cluster`` runtime — a prefill
pool and a decode pool of PyTorch ``Engine``s sharing one copy of the
weights, paged KV handoff, continuous batching, pluggable scheduler /
router / rate matcher — fed by a ``repro_torch.workloads`` scenario, and
prints SLA metrics as one JSON object.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --prefill-engines 1 --decode-engines 2 --requests 16 --isl 512 \\
      --osl 64 --slots 8 --rate-matcher elastic

The full configuration runs on the card (``--device`` defaults to
``cuda``); ``--smoke`` takes the smoke-sized configuration and
``--device cpu`` the plain PyTorch path, as the tests do. Engines default
to the ``h100`` chip class, so the virtual clock reads measured card time.
Not yet ported: ``--backend sim``, ``--calibrate``, ``--trace-out``,
``--mode coloc`` and the chunked schedulers (they need chunked prefill).
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.hardware import CHIP_NAMES, get_chip
from repro_torch.serving.backends import (BACKENDS, init_torch_params,
                                          make_engine)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.elastic import ElasticConfig, ElasticRateMatcher
from repro_torch.serving.policies import (ElasticPolicy, FCFSScheduler,
                                          FirstFitRouter, KVLocalityRouter,
                                          LeastLoadedRouter, PriorityScheduler,
                                          RoundRobinRouter,
                                          StaticSplitRateMatcher)
from repro_torch.workloads import (Burst, Diurnal, FixedShape,
                                   OpenLoopWorkload, Poisson)

SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "priority": PriorityScheduler,
}
ROUTERS = {
    "first-fit": FirstFitRouter,
    "round-robin": RoundRobinRouter,
    "least-loaded": LeastLoadedRouter,
    "kv-locality": KVLocalityRouter,
}
WORKLOADS = ("poisson", "burst", "diurnal")


def build_workload(args, vocab: int):
    """(workload, expected_completions) from the CLI axis."""
    arrivals = {
        "poisson": lambda: Poisson(args.rate),
        "burst": lambda: Burst(args.requests),
        "diurnal": lambda: Diurnal(args.rate, amplitude=0.8,
                                   period=args.requests / args.rate),
    }[args.workload]()
    w = OpenLoopWorkload(arrivals, FixedShape(args.isl, args.osl),
                         vocab=vocab, seed=args.seed,
                         max_requests=args.requests, horizon_s=3600.0)
    return w, args.requests


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's smoke-sized configuration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain PyTorch path)")
    ap.add_argument("--backend", choices=BACKENDS, default="torch")
    ap.add_argument("--mode", choices=["disagg"], default="disagg")
    ap.add_argument("--scheduler", choices=sorted(SCHEDULERS), default="fcfs")
    ap.add_argument("--router", choices=sorted(ROUTERS), default="round-robin")
    ap.add_argument("--rate-matcher", choices=["none", "elastic", "static"],
                    default="elastic")
    ap.add_argument("--workload", choices=WORKLOADS, default="poisson")
    ap.add_argument("--static-alpha", type=float, default=0.5,
                    help="prefill:decode ratio for --rate-matcher static")
    ap.add_argument("--prefill-engines", type=int, default=1)
    ap.add_argument("--decode-engines", type=int, default=2)
    ap.add_argument("--prefill-chip", choices=CHIP_NAMES, default="h100",
                    help="hardware class of the prefill pool (virtual step "
                    "times scale by the chip's speed relative to the H100)")
    ap.add_argument("--decode-chip", choices=CHIP_NAMES, default="h100",
                    help="hardware class of the decode pool")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--isl", type=int, default=48)
    ap.add_argument("--osl", type=int, default=12)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    params = init_torch_params(cfg, args.seed, device=args.device)
    work, expected = build_workload(args, cfg.vocab_size)
    capacity = args.isl + args.osl + 8

    built = []      # every engine, including any the matcher drains

    def mk(i, chip_name):
        built.append(make_engine(
            args.backend, i, cfg, params, slots=args.slots,
            capacity=capacity, chip=get_chip(chip_name),
            device=params["embed"].device))
        return built[-1]

    rate_matcher = {
        "none": lambda: None,
        "elastic": lambda: ElasticPolicy(
            ElasticRateMatcher(ElasticConfig())),
        "static": lambda: StaticSplitRateMatcher(args.static_alpha),
    }[args.rate_matcher]()
    cluster = Cluster(
        {"prefill": [mk(i, args.prefill_chip)
                     for i in range(args.prefill_engines)],
         "decode": [mk(100 + i, args.decode_chip)
                    for i in range(args.decode_engines)]},
        scheduler=SCHEDULERS[args.scheduler](),
        router=ROUTERS[args.router](), rate_matcher=rate_matcher)
    metrics = cluster.serve(work)
    extra = {"transfers": cluster.stats.transfers,
             "transferred_MB": cluster.stats.transferred_bytes / 2**20,
             "prefill_pool": len(cluster.prefill_pool),
             "decode_pool": len(cluster.decode_pool),
             "hardware": cluster.pool_hardware(),
             "device": str(params["embed"].device),
             "prefills": sum(e.prefills for e in built),
             "decode_steps": sum(e.decode_steps for e in built),
             "mean_prefill_step_s": sum(e.prefill_s for e in built)
             / max(sum(e.prefills for e in built), 1),
             "mean_decode_step_s": sum(e.decode_s for e in built)
             / max(sum(e.decode_steps for e in built), 1)}
    if rate_matcher is not None:
        extra["rate_matcher_moves"] = rate_matcher.moves
    record = {"arch": cfg.name, "mode": args.mode, "backend": args.backend,
              "workload": args.workload, "scheduler": args.scheduler,
              "router": args.router, "rate_matcher": args.rate_matcher,
              **{k: round(v, 4) for k, v in metrics.items()}, **extra}
    print(json.dumps(record, indent=1, default=str))
    assert metrics["completed"] == expected
    return record


if __name__ == "__main__":
    main()
