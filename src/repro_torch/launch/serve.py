"""Serving launcher of the port: disaggregated or co-located.

Runs the model through the policy-driven ``Cluster`` runtime — PyTorch
``Engine``s sharing one copy of the weights, continuous batching,
pluggable scheduler / router / rate matcher — fed by a
``repro_torch.workloads`` scenario, and prints SLA metrics as one JSON
object. ``--mode disagg`` (the default) runs a prefill pool and a decode
pool with paged KV handoff; ``--mode coloc`` runs one ``"mixed"`` pool of
``--prefill-engines + --decode-engines`` engines with chunked prefill and
decode piggybacked between chunks (``ChunkedPiggybackScheduler``) and the
``kv-locality`` router, so no KV crosses engines.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --prefill-engines 1 --decode-engines 2 --requests 16 --isl 512 \\
      --osl 64 --slots 8 --rate-matcher elastic
  PYTHONPATH=src python -m repro_torch.launch.serve --mode coloc \\
      --scheduler prefix-affinity --workload sessions --turns 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --requests 16 --isl 512 --osl 64 --slots 8

``--arch rwkv6-1.6b`` (attention-free) serves disaggregated only: the
prefill engine hands its O(1) recurrent state to a dense decode engine.
Its prompts are never chunked, so ``--mode coloc`` and ``--scheduler
prefix-affinity`` (both chunked prefill) are refused at start-up, where
the reference fails inside its chunked prefill.

The full configuration runs on the card (``--device`` defaults to
``cuda``); ``--smoke`` takes the smoke-sized configuration and
``--device cpu`` the plain PyTorch path, as the tests do. Engines default
to the ``h100`` chip class, so the virtual clock reads measured card time.

``--backend sim`` swaps every engine for the analytic-time ``SimEngine``
(``serving/simengine.py``): the same policies and workload on
roofline-clocked O(1) steps, with no params and no card. ``--calibrate``
first fits the roofline scale per chip against a short run of the torch
``Engine`` on ``--device`` (on the card: through the hand-written
kernels), persisted to ``--calibration-path`` and reused by later sim
runs; a chip with no fit there runs on the raw roofline, and says so.
``--trace`` replays a JSONL trace (overriding ``--workload``);
``--trace-out`` attaches a span ``TraceRecorder`` and writes a
Chrome/Perfetto trace. ``REPRO_SANITIZE=1`` turns on the cluster's
invariant sanitizer.

  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \
      --calibrate --requests 16 --isl 512 --osl 64 --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --trace tests/data/traces/burst.jsonl --trace-out trace.json

Where it differs from ``repro.launch.serve``: the engines' capacity also
holds the pad that chunked prefill adds to a prompt (up to a chunk less
one token), which the reference's capacity leaves out; the record names
the step counts and mean step times of torch engines, and leaves them
out under ``--backend sim``, whose engines do not count them.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.hardware import CHIP_NAMES, get_chip
from repro_torch.serving.backends import (BACKENDS, init_torch_params,
                                          make_engine)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.elastic import ElasticConfig, ElasticRateMatcher
from repro_torch.serving.policies import (ChunkedPiggybackScheduler,
                                          ElasticPolicy, FCFSScheduler,
                                          FirstFitRouter, KVLocalityRouter,
                                          LeastLoadedRouter,
                                          PrefixAffinityScheduler,
                                          PriorityScheduler,
                                          RoundRobinRouter,
                                          StaticSplitRateMatcher)
from repro_torch.serving.simengine import calibrate, load_calibration
from repro_torch.workloads import (Burst, Diurnal, FixedShape,
                                   OpenLoopWorkload, Poisson,
                                   SessionWorkload, TraceReplay)

SCHEDULERS = {
    "fcfs": lambda chunk: FCFSScheduler(),
    "priority": lambda chunk: PriorityScheduler(),
    "prefix-affinity": lambda chunk: PrefixAffinityScheduler(chunk=chunk),
}
ROUTERS = {
    "first-fit": FirstFitRouter,
    "round-robin": RoundRobinRouter,
    "least-loaded": LeastLoadedRouter,
    "kv-locality": KVLocalityRouter,
}
WORKLOADS = ("poisson", "burst", "diurnal", "sessions")


def build_workload(args, vocab: int):
    """(workload, expected_completions) from the CLI axis."""
    if args.trace:
        w = TraceReplay(args.trace, vocab=vocab, seed=args.seed)
        if not w.requests:
            raise SystemExit(f"--trace {args.trace}: no records found")
        return w, len(w.requests)
    if args.workload == "sessions":
        w = SessionWorkload(vocab=vocab, seed=args.seed,
                            sessions=args.requests, turns=args.turns,
                            families=max(args.requests // 2, 1),
                            system_prefix_len=args.isl // 2,
                            user_isl=max(args.isl // 2, 1), osl=args.osl,
                            think_time=args.think_time)
        return w, args.requests * args.turns
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
    ap.add_argument("--backend", choices=BACKENDS, default="torch",
                    help="'torch' runs the model on --device; 'sim' runs "
                    "the analytic-time SimEngine (no params, no card)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit (and persist) the sim roofline scale from a "
                    "short torch-engine run on --device before serving "
                    "(--backend sim)")
    ap.add_argument("--calibration-path", default=".sim_calibration.json",
                    help="JSON table of per-(model, chip) roofline scales")
    ap.add_argument("--mode", choices=["disagg", "coloc"], default="disagg")
    ap.add_argument("--scheduler", choices=sorted(SCHEDULERS), default="fcfs")
    ap.add_argument("--router", choices=sorted(ROUTERS), default=None,
                    help="default: round-robin (disagg) / kv-locality "
                    "(coloc)")
    ap.add_argument("--rate-matcher", choices=["none", "elastic", "static"],
                    default="elastic")
    ap.add_argument("--workload", choices=WORKLOADS, default="poisson",
                    help="arrival/scenario shape; 'sessions' is closed-loop "
                    "multi-turn (--requests = #conversations)")
    ap.add_argument("--trace", default=None,
                    help="JSONL trace to replay (overrides --workload)")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per conversation for --workload sessions")
    ap.add_argument("--think-time", type=float, default=0.05,
                    help="seconds between a turn's completion and the next")
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
    ap.add_argument("--piggyback-chunk", type=int, default=16,
                    help="prefill chunk of --mode coloc and of the prefix "
                    "cache (--scheduler prefix-affinity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="attach a span TraceRecorder and write a Chrome/"
                    "Perfetto trace (one track per engine, async slices "
                    "per request, counter tracks) to this path")
    args = ap.parse_args(argv)
    if args.calibrate and args.backend != "sim":
        ap.error("--calibrate fits the sim roofline scale; pass "
                 "--backend sim with it")
    if args.scheduler == "prefix-affinity" and args.piggyback_chunk <= 0:
        ap.error("--scheduler prefix-affinity needs --piggyback-chunk > 0 "
                 "(engines must be built with a PrefixCache)")

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.block != "attn" and (args.mode == "coloc"
                                or args.scheduler == "prefix-affinity"):
        ap.error(f"--arch {args.arch}: {cfg.block} prompts are never "
                 "chunked, so --mode coloc and --scheduler prefix-affinity "
                 "(chunked prefill) do not apply; use --mode disagg")
    params = None
    if args.backend == "torch":         # sim serves without params
        params = init_torch_params(cfg, args.seed, device=args.device)
    work, expected = build_workload(args, cfg.vocab_size)
    # one chunk value feeds both the engines' PrefixCache and the scheduler
    chunk = (args.piggyback_chunk
             if args.scheduler == "prefix-affinity" else 0)
    piggyback = args.mode == "coloc" and args.scheduler == "fcfs"
    capacity = chunk_capacity(args, work, chunk or (
        args.piggyback_chunk if piggyback else 0))

    # one calibration load per distinct chip; a chip with no persisted fit
    # runs on the raw roofline scale (announced, never silently borrowed
    # from another chip's fit)
    cal_by_chip = {}
    if args.backend == "sim":
        cal_params = None
        if args.calibrate:      # params are chip-independent: init once
            cal_params = init_torch_params(cfg, args.seed,
                                           device=args.device)
        # only the chips this mode actually builds (coloc runs one mixed
        # pool on the prefill chip — no decode-chip engines to calibrate)
        chips_needed = ({args.prefill_chip} if args.mode == "coloc"
                        else {args.prefill_chip, args.decode_chip})
        for chip_name in sorted(chips_needed):
            if args.calibrate:
                cal = calibrate(cfg, cal_params, chip=get_chip(chip_name),
                                path=args.calibration_path, seed=args.seed,
                                device=args.device)
                print(f"# calibrated {cfg.name}/{chip_name}: "
                      f"prefill x{cal.prefill_scale:.3g} "
                      f"decode x{cal.decode_scale:.3g}", file=sys.stderr)
            cal_by_chip[chip_name] = load_calibration(
                args.calibration_path, cfg.name, get_chip(chip_name))
        missing = sorted(c for c, v in cal_by_chip.items() if v is None)
        if missing:
            print(f"note: no calibration for {cfg.name} on "
                  f"{'/'.join(missing)} in {args.calibration_path}; those "
                  "engines use raw roofline scales (run --calibrate to "
                  "fit)", file=sys.stderr)

    built = []      # every engine, including any the matcher drains
    device = params["embed"].device if params is not None else None

    def mk(i, chip_name):
        built.append(make_engine(
            args.backend, i, cfg, params, slots=args.slots,
            capacity=capacity, chunk_size=chunk, chip=get_chip(chip_name),
            device=device, calibration=cal_by_chip.get(chip_name)))
        return built[-1]

    recorder = None
    if args.trace_out:
        from repro_torch.serving.tracing import TraceRecorder
        recorder = TraceRecorder()

    scheduler = SCHEDULERS[args.scheduler](chunk)
    sched_name = args.scheduler
    rate_matcher = {
        "none": lambda: None,
        "elastic": lambda: ElasticPolicy(
            ElasticRateMatcher(ElasticConfig())),
        "static": lambda: StaticSplitRateMatcher(args.static_alpha),
    }[args.rate_matcher]()
    if args.mode == "disagg":
        router_name = args.router or "round-robin"
        rm_name = args.rate_matcher
        cluster = Cluster(
            {"prefill": [mk(i, args.prefill_chip)
                         for i in range(args.prefill_engines)],
             "decode": [mk(100 + i, args.decode_chip)
                        for i in range(args.decode_engines)]},
            scheduler=scheduler, router=ROUTERS[router_name](),
            rate_matcher=rate_matcher, recorder=recorder)
    else:
        if piggyback and args.piggyback_chunk:
            scheduler = ChunkedPiggybackScheduler(args.piggyback_chunk)
            sched_name = f"chunked-piggyback:{args.piggyback_chunk}"
        if args.rate_matcher != "none":
            print(f"note: --rate-matcher {args.rate_matcher} ignored in "
                  "coloc mode (a single mixed pool has no split to size)",
                  file=sys.stderr)
        rate_matcher = None
        router_name = args.router or "kv-locality"
        rm_name = "none"
        if args.decode_chip != args.prefill_chip:
            print("note: coloc mode runs one mixed pool; using "
                  f"--prefill-chip {args.prefill_chip} for every engine",
                  file=sys.stderr)
        cluster = Cluster(
            {"mixed": [mk(i, args.prefill_chip)
                       for i in range(args.prefill_engines
                                      + args.decode_engines)]},
            scheduler=scheduler, router=ROUTERS[router_name](),
            rate_matcher=None, recorder=recorder)
    metrics = cluster.serve(work)
    if recorder is not None:
        from repro_torch.serving.obs import export_perfetto
        counts = export_perfetto(recorder, args.trace_out, metrics=metrics)
        print(f"# trace: {args.trace_out} ({counts['total']} events, "
              f"{counts['X']} slices, {counts['b']} request phases, "
              f"{len(recorder.dumps)} flight dumps) — load in "
              "ui.perfetto.dev or chrome://tracing", file=sys.stderr)
    extra = {"transfers": cluster.stats.transfers,
             "transferred_MB": cluster.stats.transferred_bytes / 2**20,
             "hardware": cluster.pool_hardware(),
             "capacity": capacity,
             "prefix_hits": sum(e.prefix_cache.hits for e in built
                                if e.prefix_cache is not None)}
    if args.backend == "torch":     # sim engines keep no step counts
        n_prefills = sum(e.prefills for e in built)
        n_decode = sum(e.decode_steps for e in built)
        extra.update(
            device=str(device), prefills=n_prefills,
            decode_steps=n_decode,
            mean_prefill_step_s=sum(e.prefill_s for e in built)
            / max(n_prefills, 1),
            mean_decode_step_s=sum(e.decode_s for e in built)
            / max(n_decode, 1))
    if args.mode == "disagg":
        extra["prefill_pool"] = len(cluster.prefill_pool)
        extra["decode_pool"] = len(cluster.decode_pool)
    if rate_matcher is not None:
        extra["rate_matcher_moves"] = rate_matcher.moves
    record = {"arch": cfg.name, "mode": args.mode, "backend": args.backend,
              "workload": "trace" if args.trace else args.workload,
              "scheduler": sched_name,
              "router": router_name, "rate_matcher": rm_name,
              **{k: round(v, 4) for k, v in metrics.items()}, **extra}
    print(json.dumps(record, indent=1, default=str))
    assert metrics["completed"] == expected
    return record


def chunk_capacity(args, work, chunk: int) -> int:
    """Engine capacity: the workload's largest context (its ``max_context``
    where it has one, else isl + osl) plus 8, as the reference's launcher,
    plus the pad that chunked prefill adds to a prompt. A fixed-shape
    prompt pads by ``(-isl) % chunk``; a session turn's length is not known
    ahead, so up to ``chunk - 1``."""
    max_ctx = getattr(work, "max_context", lambda: None)()
    pad = 0
    if chunk:
        pad = chunk - 1 if max_ctx else (-args.isl) % chunk
    return (max_ctx or (args.isl + args.osl)) + 8 + pad


if __name__ == "__main__":
    main()
