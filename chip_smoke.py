#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: every CUDA source of ``src/repro_torch`` with ``nvcc`` (one
     process per source, all at once), printing each kernel's ptxas
     register, spill and static shared-memory lines;
  3. kernels: each kernel's wrapper on the card at the main path's shapes,
     held against its plain PyTorch version on the same inputs (bf16 in,
     tolerance stated below) — flash attention also at chunked-prefill
     shapes (16 or 64 query rows at an offset), the paged kernel also
     against poisoned trash/tail blocks, the dense decode kernel against
     poisoned rows at and past each length; then timed with CUDA events
     over runs that cycle through more inputs than the L2 holds, and by
     the profiler's device time (the paged kernel's split and merge
     kernels apart), beside the plain version, the library call where
     PyTorch has one (its device time too), and the bound computed from
     the shapes — at the main path's shapes and at one larger shape; the
     dense decode kernel also at the edges of its shape-chosen split (32,
     48 and 64 rows; lengths 0, 1, at and around split boundaries, Smax),
     each with the poisoned-row check; the WKV kernel (RWKV-6) against
     its sequential oracle at rwkv6-1.6b's prefill (S=512, also a ragged
     S=500 and a near-total decay) and decode shapes, from a nonzero
     state, and at the edges of its column blocks (N = 32 and 64, bf16
     and fp32 inputs, B > 1), each also in place, then timed beside its
     plain chunked version (no PyTorch call computes the recurrence);
  4. model: full-width qwen2.5-3b (36 layers, bf16, random weights from
     seed 0), prefill and paged decode steps with the kernels, with the
     plain path, and with the plain path in float32 on the same weights,
     pools and tables; the kernel path must be no farther from float32
     than twice the plain bf16 path;
  5. serve: ``repro_torch.launch.serve.main`` — 16 requests of 512 prompt
     and 64 output tokens, 1 prefill and 2 decode engines with 8 slots, the
     elastic rate matcher — with every kernel's launch count set to 0 just
     before and read just after; fails unless all 16 complete and each
     kernel ran once per layer per prefill / decode step;
  6. co-located serve: ``--mode coloc``, 8 requests of 512/64 on one mixed
     pool of 2 engines, chunked prefill (64-token chunks, each chunk's
     attention through the flash kernel at its offset) with a decode round
     piggybacked after every chunk; fails unless all complete with no KV
     transfer, flash ran at least once per layer per chunk and the paged
     kernel once per layer per decode step;
  7. prefix-affinity serve: ``--mode coloc --scheduler prefix-affinity
     --workload sessions``, 2 conversations of 2 turns; fails unless every
     turn completes and the engines' prefix caches report hits;
  8. dense serve: a disaggregated cluster of dense-layout engines
     (``paged=False``), 4 requests of 512/32; fails unless the dense
     decode kernel ran once per layer per decode step and the paged kernel
     not at all; prints how long a prefix of the first request's stream
     agrees with the paged layout's (bf16 argmax ties may differ);
  9. RWKV-6 model: full-width rwkv6-1.6b (24 layers, bf16, random weights
     from seed 0), prefill of 4 prompts of 512 and dense decode steps, the
     same three ways and the same rule as phase 4; besides, layer 0's
     fp32 state after the prefill and after one decode step must agree
     between the kernel and the plain bf16 path (same inputs there) within
     the WKV tolerance, and its token-shift state exactly;
 10. RWKV-6 serve: ``serve.main`` with ``--arch rwkv6-1.6b``, disaggregated
     as phase 5; fails unless all 16 complete, the WKV kernel ran once
     per layer per prefill and decode step, no attention kernel ran, and
     every handoff carried exactly one request's state (12,779,520 bytes);
 11. profile: one engine of the serve's shape, a prefill and a decode
     step under ``torch.profiler`` (host-clock step time, device time,
     idle share, the kernels that take the most time), for qwen2.5-3b in
     the paged and the dense layout and for rwkv6-1.6b;
 12. calibrate: ``simengine.calibrate`` on the card, ``h100`` chip, at the
     serve's shape (isl 512, osl 64, 8 slots filled by 8 + 1 prefills) for
     qwen2.5-3b and rwkv6-1.6b on phase 4's and 9's weights, into a
     temporary calibration table; prints measured and predicted seconds
     and both scales per model; fails unless every scale is finite and
     positive, flash ran at least once per layer per prefill and paged
     decode once per layer per decode step for qwen, and WKV once per
     layer per prefill and decode step for rwkv; then ``serve.main
     --backend sim --calibrate --requests 4`` on the card (full width:
     the smoke configuration's head dim, 16, is not one the attention
     kernels take);
 13. sim serve: ``serve.main --backend sim`` on that table with phase 5's
     and phase 10's traffic; fails unless every request completes and no
     kernel launched; prints the simulated against the real serve's p50
     FTL, p50 TTL and tokens/s, and fails unless both latency ratios lie
     in (0.1, 10);
 14. traced serve: phase 5's serve again with ``--trace-out`` and
     ``REPRO_SANITIZE=1``; fails unless the trace is valid JSON with one
     track per engine, every request's phases tile [arrival, done] within
     1e-9 s, and the sanitizer saw every request through; prints its step
     times beside phase 5's; then replays ``tests/data/traces/burst.jsonl``
     through ``--trace`` at full width and fails unless all complete;
 15. 14B models: full-width, full-depth qwen3-14b (40 layers, 40/8 heads:
     G = 5, qk_norm) and phi3-medium-14b (40 layers, 40/10 heads), bf16,
     random weights from seed 0, each checked as phase 4 (prefill of 512,
     4 paged decode steps, three ways, the same rule) with the float32
     reference upcast one block at a time beside the bf16 weights; each
     model freed before the next, its peak memory printed;
 16. 14B serves: ``serve.main --arch qwen3-14b`` and ``--arch
     phi3-medium-14b`` with phase 5's traffic; fails unless all 16
     complete, flash ran exactly 40 times per prefill, paged decode exactly
     40 times per decode step and per engine's warm-up step, and neither
     dense decode nor WKV ran;
 17. sweep: ``python -m repro_torch.launch.sweep`` over the design grid of
     five models (the paper's llama-3.1-8b and the four registered
     architectures) x h100, a100, h100:a100 x ISL 512/2048/8192 x OSL
     64/256 x reuse 0/0.5 x disagg/coloc, 64 chips at most, with the
     simulate axis, 4 worker processes, into a temporary store, on the
     host (no CUDA in the subprocess); fails unless its ``spec_hash`` is
     4944b71631008786 and it evaluated 695,418 points in 240 cells, and a
     rerun is 240 cache hits with the same points and frontier areas;
     prints records, frontier areas, points per second and host seconds;
 18. granite model: full-width, full-depth granite-moe-1b-a400m (24
     layers, 16/8 heads of 64, every FFN a capacity-based MoE of 32
     experts top-8), bf16, random weights from seed 0, checked as phase 4
     (three ways, the same rule), with each path's MoE routing against
     the float32 reference's (layer x token pairs routed to another top-k
     set) and the tokens each prefill drops;
 19. granite serve: ``serve.main --arch granite-moe-1b-a400m`` with phase
     5's traffic; fails unless all 16 complete, flash ran exactly 24 times
     per prefill and paged decode exactly 24 times per decode step and
     per engine's warm-up step (both at head dim 64), neither dense decode
     nor WKV ran, and each handoff carried 24 MiB;
 20. granite profile: phase 11 for granite's engine, with the MoE FFN's
     device time, share and launches per step.

Phase 3 also holds flash, paged and dense decode at head dim 64 (granite's
16/8 heads) against their plain versions at the serve's shapes and their
edges, and times each beside its bound and SDPA's device time.

Every path (5-8, 10, 12-14, 16, 19) runs with every kernel's launch count
set to 0 just before it and read just after; each phase prints its
seconds.

The last three lines of standard output are the card's name and power
limit, the ``{"kernels": [...]}`` record and ``{"ok": true, "device":
...}``. Without a card, or without the repository beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on
# the CUDA cores (the WKV recurrence's arithmetic), HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# bf16 outputs round at 2^-8 relative and the kernels round p to bf16 for
# the tensor cores; the JAX package's bf16 kernel tests use the same bound
KERNEL_ATOL = 2e-2
# the WKV kernel and its oracle both compute in fp32 from the same inputs
# and differ only in summation order: relative to the output's scale
WKV_RTOL = 1e-4
L2_BYTES = 50 << 20                     # H100 SXM L2 cache
# the serve paths' traffic (phases 5, 10, 13 and 14)
SERVE_ARGS = ["--requests", "16", "--isl", "512", "--osl", "64", "--slots",
              "8", "--prefill-engines", "1", "--decode-engines", "2",
              "--rate-matcher", "elastic"]
# the simulated against the real serve's p50 FTL and TTL: within an order
# of magnitude, the reference's own bound for its calibrated sim
SIM_RATIO = (0.1, 10.0)
# the 14B dense configurations' (query, KV) heads: qwen3-14b's G = 5 packs
# 12 positions into 60 of a flash tile's 64 rows
HEADS_14B = {"qwen3-14b": (40, 8), "phi3-medium-14b": (40, 10)}
# granite-moe-1b-a400m's (query, KV) heads, of dh 64
GRANITE = "granite-moe-1b-a400m"
HEADS_GRANITE = (16, 8)
# phase 17's design grid, its content address and the perf-model points it
# evaluates (both deterministic: the JAX package's sweep gives the same)
SWEEP_ARGS = ["--models", "llama-3.1-8b", "qwen3-14b", "phi3-medium-14b",
              "qwen2.5-3b", "rwkv6-1.6b", "--hardware", "h100", "a100",
              "h100:a100", "--isl", "512", "2048", "8192", "--osl", "64",
              "256", "--reuse", "0.0", "0.5", "--modes", "disagg", "coloc",
              "--max-chips", "64", "--simulate", "--workers", "4", "--quiet"]
SWEEP_HASH, SWEEP_POINTS, SWEEP_CELLS = "4944b71631008786", 695_418, 240


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class Timer:
    """Time per call: CUDA events around a run of calls that cycle through
    enough independent input sets to exceed twice the 50 MB L2, so each
    call reads its inputs from HBM as it would on the main path. The median
    over ``runs`` runs, divided by the calls in a run. Where a call's
    kernels take less time than the host needs to issue it (a wrapper's
    checks and allocations, tens of microseconds), the events measure the
    host's pace: ``device`` reads the kernels' own time from the profiler
    instead."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, cases, runs: int = 5) -> float:
        torch = self.torch
        for case in cases:                      # warm-up
            fn(*case)
        torch.cuda.synchronize()
        per_call = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for case in cases:
                fn(*case)
            end.record()
            torch.cuda.synchronize()
            per_call.append(start.elapsed_time(end) / len(cases))
        per_call.sort()
        return per_call[len(per_call) // 2]

    def device(self, fn, cases):
        """The device time of the kernels one call launches (their sum, per
        call), from ``torch.profiler`` over one pass through the cases;
        None where the profiler saw none."""
        parts = self.device_by_kernel(fn, cases)
        return sum(parts.values()) if parts else None

    def device_by_kernel(self, fn, cases, tries: int = 3) -> dict:
        """Each kernel's device time per call, by the profiler's kernel
        name, over one pass through the cases. The profiler now and then
        reports no device activity for a pass: such a pass is repeated,
        and after ``tries`` empty ones the result is {} (not measured)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        for case in cases:                      # warm-up
            fn(*case)
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for case in cases:
                    fn(*case)
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = (by_name.get(e.name, 0.0)
                                       + e.time_range.elapsed_us() / 1e3
                                       / len(cases))
            if by_name:
                return by_name
        return {}


def ptxas_entry(line: str) -> str:
    """The kernel a ptxas "Compiling entry function '_ZN...'" line names:
    the last name of its mangled nested name, with its template arguments:
    the WKV kernel's (``wkv_kernel<64, bf16>``), the attention kernels'
    head dim (``flash_fwd_kernel<64>``)."""
    m = line.split("'")[1]
    i, name = (3 if m.startswith("_ZN") else 2), m
    while i < len(m) and m[i].isdigit():
        j = i
        while m[j].isdigit():
            j += 1
        n = int(m[i:j])
        name, i = m[j:j + n], j + n
    targs = re.match(r"ILi(\d+)E(f|13__nv_bfloat16)?E", m[i:])
    if targs and targs.group(2):
        name += f"<{targs.group(1)}, " + (
            "fp32" if targs.group(2) == "f" else "bf16") + ">"
    elif targs:
        name += f"<{targs.group(1)}>"
    return name


def split_and_merge(parts: dict, split_kernel: str) -> dict:
    """A decode kernel's device time per call from the profiler's parts
    by kernel name: the total, its split kernel's and the merge's (None,
    not measured, where the profiler saw none)."""
    def part(name):
        return sum(t for k, t in parts.items() if name in k) if parts else None
    return {"device_ms": sum(parts.values()) if parts else None,
            "split_device_ms": part(split_kernel),
            "merge_device_ms": part("split_merge_kernel")}


def copies(nbytes: float) -> int:
    """Input sets to cycle through: together at least twice the L2."""
    return max(2, min(64, math.ceil(2 * L2_BYTES / nbytes)))


def flash_case(torch, gen, B, Sq, Skv, H, Hkv, dev, dh=128):
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(  # noqa
        torch.bfloat16)
    return mk(B, Sq, H, dh), mk(B, Skv, Hkv, dh), mk(B, Skv, Hkv, dh)


def flash_work(B, Sq, Skv, H, Hkv, q_offset, dh=128):
    pairs = sum(min(Skv, q_offset + i + 1) for i in range(Sq))  # causal
    flops = 4.0 * B * H * dh * pairs
    nbytes = 2.0 * dh * (2 * B * Sq * H + 2 * B * Skv * Hkv)
    return flops, nbytes


def paged_case(torch, gen, lengths, Bs, H, Hkv, dev, nb=None, dh=128):
    """Pool with every sequence's blocks at shuffled ids, and a table of
    ``nb`` columns (default: the pow2 width the engine's window takes; pad
    columns -> trash block 0)."""
    B = len(lengths)
    pages = [-(-n // Bs) for n in lengths]
    if nb is None:
        nb = 1
        while nb * Bs < max(lengths):
            nb *= 2
    N = 1 + sum(pages)
    pool_k = torch.randn((N, Bs, Hkv, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    pool_v = torch.randn((N, Bs, Hkv, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    ids = (torch.randperm(N - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((B, nb), dtype=torch.int32)
    for b, n in enumerate(pages):
        tables[b, :n] = torch.tensor([ids.pop() for _ in range(n)])
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, tables.to(dev), lens


def paged_work(lengths, B, nb, H, Hkv, dh=128):
    live = float(sum(lengths))
    flops = 4.0 * live * H * dh
    nbytes = (2.0 * B * H * dh * 2            # q in, out
              + 2.0 * 2 * live * Hkv * dh     # live K and V rows
              + 4.0 * B * nb + 4.0 * B)       # tables, lengths
    return flops, nbytes


def dense_case(torch, gen, lengths, Smax, H, Hkv, dev, dh=128):
    """q, dense caches [B,Smax,Hkv,dh] and int32 lengths."""
    B = len(lengths)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(  # noqa
        torch.bfloat16)
    return (mk(B, H, dh), mk(B, Smax, Hkv, dh), mk(B, Smax, Hkv, dh),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def dense_work(lengths, B, H, Hkv, dh=128):
    """What the dense decode function must do for these lengths: the live
    K/V rows once (not the Smax-wide cache), q in, out, lengths."""
    live = float(sum(lengths))
    flops = 4.0 * live * H * dh
    nbytes = 2.0 * B * H * dh * 2 + 2.0 * 2 * live * Hkv * dh + 4.0 * B
    return flops, nbytes


def dense_split_edges(torch, dev, gen, dec_ops, ref_fn) -> float:
    """The dense decode kernel at the edges of its split, 32, 48 and 64
    rows chosen from the shape (``ops.split_tokens``), in a cache of 584
    rows (no multiple of any of them) and of 100: lengths 0, 1, one short
    of, at and one past a split boundary, Smax - 1, Smax and past it,
    against its plain version; then every row at and past each length
    poisoned (+-1e4, NaN further on in every other sequence) must leave
    the output bit-unchanged. Returns the largest error."""
    err_max = 0.0
    for B, Smax in [(8, 584), (12, 584), (16, 584), (4, 100)]:
        T = dec_ops.split_tokens(B, 2, Smax)
        edges = [0, 1, T - 1, T, T + 1, 2 * T, Smax - 1, Smax, Smax + 5,
                 Smax - T, Smax - T + 1, 3 * T - 1, T // 2, 2 * T + 1, 5,
                 77]
        lengths = edges[:B]
        q, kc, vc, lens = dense_case(torch, gen, lengths, Smax, 16, 2, dev)
        out = dec_ops.decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        err = (out.float() - ref_fn(q, kc, vc, lens).float()
               ).abs().max().item()
        kc2, vc2 = kc.clone(), vc.clone()
        for b, n in enumerate(lengths):
            kc2[b, n:], vc2[b, n:] = 1e4, -1e4
            if b % 2:
                kc2[b, n + 3:], vc2[b, n + 3:] = float("nan"), float("nan")
        same = torch.equal(out, dec_ops.decode_attention(q, kc2, vc2, lens))
        log(f"# dense split edges B={B} Smax={Smax} split={T} "
            f"lengths={lengths}: max_abs_err {err:.3e}, poisoned rows "
            f"{'bit-unchanged' if same else 'LEAKED'}")
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"dense decode at split {T} disagrees: {err}")
        if not same:
            fail(f"dense decode at split {T}: rows at or past a length "
                 "leaked into the output")
        err_max = max(err_max, err)
    return err_max


def wkv_case(torch, gen, B, S, H, N, dev, logw=None, in_dtype=None):
    """bf16 r, k, v (or ``in_dtype``); fp32 data-dependent logw =
    -exp(normal - 0.5) (or the given constant), u and a nonzero state, as
    the model passes them."""
    def f32(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k, v = (f32(B, S, H, N).to(in_dtype or torch.bfloat16)
               for _ in range(3))
    lw = (-torch.exp(f32(B, S, H, N) - 0.5) if logw is None
          else torch.full((B, S, H, N), float(logw), device=dev))
    return r, k, v, lw, f32(H, N) * 0.5, f32(B, H, N, N) * 0.1


def wkv_work(B, S, H, N):
    """The recurrence's least work for these shapes: per token and head
    y = r S (N^2 fused multiply-adds) and S = w S + k^T v (3 N^2
    operations), plus the u term; r, k, v read once in bf16, logw once and
    y written once in fp32, u once, the state read and written once."""
    flops = float(B * S * H) * (5 * N * N + 4 * N)
    nbytes = (float(B * S * H * N) * (3 * 2 + 4 + 4) + 4.0 * H * N
              + 2 * 4.0 * B * H * N * N)
    return flops, nbytes


def wkv_column_blocks(torch, dev, gen, wkv_ops, wkv_ref) -> float:
    """The WKV kernel at the edges of its column blocks (16 state columns
    per CTA, N / 16 blocks per head): N = 32 and 64, bf16 and fp32 r/k/v,
    B > 1, S of one token, ragged against the 64-token tile and longer
    than one tile, against the sequential oracle within WKV_RTOL of the
    output's scale; each then in place (``out_state=state0``), which must
    equal the out-of-place result bit for bit. Returns the largest
    error."""
    err_max = 0.0
    for B, S, H, N, dt in [(2, 33, 4, 32, torch.bfloat16),
                           (3, 70, 4, 32, torch.float32),
                           (2, 130, 8, 64, torch.float32),
                           (4, 1, 8, 64, torch.float32),
                           (3, 65, 6, 64, torch.bfloat16)]:
        case = wkv_case(torch, gen, B, S, H, N, dev, in_dtype=dt)
        y, s = wkv_ops.wkv(*case)
        state = case[5].clone()
        y2, s2 = wkv_ops.wkv(*case[:5], state, out_state=state)
        torch.cuda.synchronize()
        y_r, s_r = wkv_ref(*case)
        err = max((y - y_r).abs().max().item(), (s - s_r).abs().max().item())
        scale = max(y_r.abs().max().item(), s_r.abs().max().item(), 1.0)
        same = s2 is state and torch.equal(state, s) and torch.equal(y2, y)
        log(f"# wkv column blocks B={B} S={S} H={H} N={N} {dt}: "
            f"max_abs_err {err:.3e} (scale {scale:.3e}); in place "
            f"{'bit-identical' if same else 'DIFFERS'}")
        if not (math.isfinite(err) and err <= WKV_RTOL * scale):
            fail(f"wkv at N={N} {dt} disagrees with its oracle: {err}")
        if not same:
            fail(f"wkv at N={N} {dt}: in place differs from out of place")
        err_max = max(err_max, err)
    return err_max


def wkv_phase(torch, dev, gen, timer, H: int = 32, N: int = 64,
              S: int = 512, long_S: int = 4096):
    """The WKV kernel at rwkv6-1.6b's heads (H of size N): at the prefill
    shape, a ragged S, near-total decay and the decode step's shape (8
    slots, one token), all from a nonzero state, against the sequential
    recurrence; in place as the decode step runs it; then timed at the
    prefill, decode and one longer shape. Returns (max abs error, the
    prefill shape's timings with the decode shape's under
    "decode_shape")."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_ref
    err_max = 0.0
    for (B, Sc, logw) in [(1, S, None), (1, S - 12, None), (1, S, -12.0),
                          (8, 1, None)]:
        case = wkv_case(torch, gen, B, Sc, H, N, dev, logw)
        y, s = wkv_ops.wkv(*case)
        torch.cuda.synchronize()
        y_r, s_r = wkv_ref(*case)
        err = max((y - y_r).abs().max().item(), (s - s_r).abs().max().item())
        scale = max(y_r.abs().max().item(), s_r.abs().max().item(), 1.0)
        log(f"# wkv B={B} S={Sc} H={H} N={N} logw={logw or 'data'}: "
            f"max_abs_err {err:.3e} (scale {scale:.3e})")
        if not (math.isfinite(err) and bool(torch.isfinite(y).all())
                and err <= WKV_RTOL * scale):
            fail(f"wkv disagrees with its sequential oracle: {err}")
        err_max = max(err_max, err)
    state = case[5].clone()                     # in place, as decode runs
    _, s = wkv_ops.wkv(*case[:5], state, out_state=state)
    torch.cuda.synchronize()
    if s is not state or not torch.equal(state, wkv_ops.wkv(*case)[1]):
        fail("wkv: the in-place state differs from the out-of-place one")
    err_max = max(err_max, wkv_column_blocks(torch, dev, gen, wkv_ops,
                                             wkv_ref))

    def time_wkv(B, Sc):
        flops, nbytes = wkv_work(B, Sc, H, N)
        cases = [wkv_case(torch, gen, B, Sc, H, N, dev)
                 for _ in range(copies(nbytes))]
        res = {"ms": timer(wkv_ops.wkv, cases),
               "device_ms": timer.device(wkv_ops.wkv, cases),
               "plain_ms": timer(wkv_chunked, cases, runs=3),
               "library_ms": None}  # no PyTorch call computes the WKV
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes,
                                                 PEAK_FP32_FLOPS)
        log(f"# wkv time B={B} S={Sc} H={H} N={N} ({len(cases)} input "
            "sets): " + json.dumps(res))
        return res

    row = time_wkv(1, S)
    row["decode_shape"] = time_wkv(8, 1)
    time_wkv(1, long_S)
    return err_max, row


def hold(torch, what, L, lk, lp, lr, vocab):
    """The model rule: the kernel path's logits no farther from the float32
    reference than twice the plain bf16 path's, plus 1e-3 of the scale.
    Only the first ``vocab`` columns count: padded vocabulary rows hold
    the mask value (-1e30), which would swamp the scale."""
    lk, lp, lr = (t[..., :vocab] for t in (lk, lp, lr))
    scale = lr.abs().max().item()
    ek = (lk - lr).abs().max().item() / scale
    ep = (lp - lr).abs().max().item() / scale
    ok = bool(torch.isfinite(lk).all()) and ek <= 2 * ep + 1e-3
    log(f"# model L={L} {what}: max err vs fp32 / scale: "
        f"kernel {ek:.3e}, plain bf16 {ep:.3e}; argmax kernel "
        f"{lk.argmax(-1).tolist()} plain {lp.argmax(-1).tolist()} "
        f"fp32 {lr.argmax(-1).tolist()}")
    if not ok:
        fail(f"{what}: kernel path error {ek} vs plain bf16 {ep}")


def upcast(params):
    """The float32 reference's weights: every leaf upcast, the blocks one
    at a time as the model walks them (``UpcastBlocks``)."""
    return {k: (UpcastBlocks(v) if k == "blocks" else v.float())
            for k, v in params.items()}


def upcast_tree(tree):
    """A block's leaves in float32, nested dicts (an MoE layer's ``moe``)
    kept."""
    return {n: (upcast_tree(t) if isinstance(t, dict) else t.float())
            for n, t in tree.items()}


def n_params(params) -> int:
    def count(tree):
        return sum(count(t) if isinstance(t, dict) else t.numel()
                   for t in tree.values())
    return count({k: v for k, v in params.items() if k != "blocks"}) + sum(
        count(b) for b in params["blocks"])


class UpcastBlocks:
    """The bf16 blocks, each upcast to float32 only while the model walks
    it: a float32 reference of a 14B model fits beside its bf16 weights
    (59 GB upcast whole, one block's 1.5 GB this way)."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __len__(self):
        return len(self.blocks)

    def __iter__(self):
        for b in self.blocks:
            yield upcast_tree(b)


class RoutingTap:
    """While on, records each MoE call's routing mask [T, E] and dropped
    count: ``moe._route`` and ``moe._local_moe`` wrapped for the model
    check only (no serve runs under it). ``take`` returns the calls since
    the last ``take``: (masks in call order, drops summed)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        route, local = self.orig = (self.moe._route, self.moe._local_moe)

        def tap_route(x, router_w, cfg):
            out = route(x, router_w, cfg)
            self.calls.append(("mask", out[1].clone()))
            return out

        def tap_local(*args, **kw):
            y, aux = local(*args, **kw)
            self.calls.append(("dropped", aux["moe_dropped"].clone()))
            return y, aux

        self.moe._route, self.moe._local_moe = tap_route, tap_local
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._local_moe = self.orig

    def take(self):
        masks = [v for k, v in self.calls if k == "mask"]
        dropped = sum(float(v) for k, v in self.calls if k == "dropped")
        self.calls = []
        return masks, dropped


def report_routing(name, what, runs) -> None:
    """The kernel and plain bf16 paths' routing against the float32
    reference's: flips are (layer, token) pairs whose top-k expert set
    differs from the reference's; drops are summed over the layers."""
    (mk, dk), (mp, dp), (mr, dr) = runs
    pairs = sum(m.shape[0] for m in mr)

    def flips(masks):
        return sum(int((a != b).any(-1).sum()) for a, b in zip(masks, mr))

    log(f"# model {name} {what}: routing against fp32 (layer x token pairs "
        f"with another top-k set, of {pairs}): kernel {flips(mk)}, plain "
        f"bf16 {flips(mp)}; moe_dropped summed over layers: kernel "
        f"{dk:.0f}, plain bf16 {dp:.0f}, fp32 {dr:.0f}")


def model_phase(torch, cfg, dev, gen, S: int = 512, steps: int = 4,
                tap=None):
    """Full-width model check; returns the bf16 weights (phase 12 fits the
    simulator on them). Prefill one prompt, then run paged decode
    steps for 4 slots that hold its cache, three ways on the same weights,
    pools and tables: bf16 with the kernels, bf16 with the plain path, and
    the plain path in float32 (weights upcast, one block at a time) as the
    reference. On random weights, bf16 rounding compounds over the layers
    into logit errors of a few percent whatever the attention, so the
    kernel path is held to the plain bf16 path's own distance from the
    float32 reference: it fails on non-finite logits, or on an error above
    twice the plain path's plus 1e-3 of the logit scale. With ``tap`` (a
    ``RoutingTap`` that is on), each step's MoE routing of the three
    paths is reported as well."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params
    params = init_torch_params(cfg, 0, device=dev)
    p32 = upcast(params)
    c32 = cfg.replace(dtype="float32")
    Bs = 8
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device=dev)

    routes = []

    def run(fn, *args, **kw):
        out = fn(*args, **kw)
        if tap is not None:
            routes.append(tap.take())
        return out

    def check(what, lk, lp, lr):
        hold(torch, f"{cfg.name} {what}", cfg.num_layers, lk, lp, lr,
             cfg.vocab_size)
        if tap is not None:
            report_routing(cfg.name, what, routes[-3:])

    with torch.inference_mode():
        lk, cache = run(T.prefill_full, params, cfg, {"tokens": prompt},
                        impl="kernel")
        lp, _ = run(T.prefill_full, params, cfg, {"tokens": prompt},
                    impl="plain")
        lr, cache32 = run(T.prefill_full, p32, c32, {"tokens": prompt},
                          impl="plain")
        check(f"prefill S={S}", lk, lp, lr)
        Lr, nbk, slots, extra = cfg.num_layers, S // Bs, 4, 8
        width = 1
        while width < nbk + extra:
            width *= 2
        n_blocks = 1 + Lr * slots * (nbk + extra)
        pools = [T.init_block_pool(c, n_blocks, Bs, device=dev)
                 for c in (cfg, cfg, c32)]
        tables = torch.zeros((Lr, slots, width), dtype=torch.int32,
                             device=dev)
        for s in range(slots):
            first = 1 + s * Lr * (nbk + extra)
            ids = torch.arange(first, first + Lr * (nbk + extra), device=dev,
                               dtype=torch.int32).reshape(Lr, nbk + extra)
            tables[:, s, :nbk + extra] = ids
            for pool, c in zip(pools, (cache, cache, cache32)):
                T.scatter_blocks(pool, ids[:, :nbk], {
                    kk: c[kk][:, 0].reshape(Lr, nbk, Bs, -1, cfg.dh)
                    for kk in ("k", "v")})
        pos = torch.full((slots,), S, dtype=torch.int32, device=dev)
        toks = torch.full((slots,), int(lr.argmax()), device=dev)
        for step in range(steps):
            dk, _, _ = run(T.decode_step_paged, params, cfg, pools[0],
                           tables, pos, toks, impl="kernel")
            dp, _, _ = run(T.decode_step_paged, params, cfg, pools[1],
                           tables, pos, toks, impl="plain")
            dr, _, _ = run(T.decode_step_paged, p32, c32, pools[2], tables,
                           pos, toks, impl="plain")
            check(f"decode step {step}", dk, dp, dr)
            pos, toks = pos + 1, dr[:, :cfg.vocab_size].argmax(-1)
    del p32, pools
    return params


def rwkv_model_phase(torch, cfg, dev, gen, B: int = 4, S: int = 512,
                     steps: int = 4):
    """Full-width RWKV-6 check: prefill B prompts of S tokens, then dense
    decode steps from each version's own state, three ways on the same
    weights (kernel bf16, plain bf16, plain fp32), held by ``hold``;
    returns the bf16 weights.

    ``hold`` allows the bf16 paths' compounded rounding, so the wiring of
    the kernel branches is held directly against the plain bf16 path as
    well: the two differ only in the WKV call, so layer 0 sees the same
    inputs in both, and its fp32 state after the prefill, and after one
    decode step of the plain path from a copy of the kernel path's state,
    must agree within ``WKV_RTOL`` of the state's scale. That checks the
    [B,S,H,N] and S = 1 reshapes and that ``out_state`` writes the cache
    row itself. The later layers' state gap is logged."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params
    params = init_torch_params(cfg, 0, device=dev)
    p32 = upcast(params)
    c32 = cfg.replace(dtype="float32")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    runs = [(params, cfg, "kernel"), (params, cfg, "plain"),
            (p32, c32, "plain")]

    def same_state(what, ck, cp):
        gap = [((sk - sp).abs().max() / sp.abs().max()).item()
               for sk, sp in zip(ck["s"], cp["s"])]
        tm = (ck["tm_x"][0] - cp["tm_x"][0]).abs().max().item()
        log(f"# model {cfg.name} {what}: kernel vs plain bf16 state gap / "
            f"scale: layer 0 {gap[0]:.3e}, max over layers {max(gap):.3e}; "
            f"layer 0 tm_x gap {tm:.3e}")
        if not gap[0] <= WKV_RTOL or tm != 0.0:
            fail(f"{cfg.name} {what}: layer 0 state of the kernel path "
                 f"differs from the plain path's (s {gap[0]}, tm_x {tm})")

    with torch.inference_mode():
        out = [T.prefill_full(p, c, {"tokens": prompt}, impl=impl)
               for p, c, impl in runs]
        hold(torch, f"{cfg.name} prefill B={B} S={S}", cfg.num_layers,
             *(lg for lg, _ in out), cfg.vocab_size)
        caches = [cache for _, cache in out]
        same_state(f"prefill B={B} S={S}", caches[0], caches[1])
        toks = out[2][0][:, :cfg.vocab_size].argmax(-1)
        twin = {k: v.clone() for k, v in caches[0].items()}
        _, twin = T.decode_step(params, cfg, twin, toks, impl="plain")
        for step in range(steps):
            logits = []
            for (p, c, impl), cache in zip(runs, caches):
                lg, _ = T.decode_step(p, c, cache, toks, impl=impl)
                logits.append(lg)
            if step == 0:
                same_state("decode step 0", caches[0], twin)
            hold(torch, f"{cfg.name} decode step {step}", cfg.num_layers,
                 *logits, cfg.vocab_size)
            toks = logits[2][:, :cfg.vocab_size].argmax(-1)
    del p32, caches, twin
    return params


def region_kernels(event):
    """The durations (us) of the device kernels launched under a profiler
    event, its CPU descendants' included."""
    out = [k.duration for k in event.kernels]
    for child in event.cpu_children:
        out += region_kernels(child)
    return out


def profile_phase(torch, cfg, dev, S: int = 512, slots: int = 8,
                  steps: int = 8, paged=None) -> None:
    """Where a step's time goes: one engine of the serve phase's shape
    (the given KV layout, or the family's default) prefills ``slots``
    prompts into its own slots, then runs decode steps with the host
    clock and then again under ``torch.profiler``; the same for two
    prefills. Prints each kind's host-clock step time, the device time of
    the kernels inside it, the device's idle share and the kernels that
    take the most time. For an MoE model the profiled steps run every
    ``moe_ffn`` call under a ``record_function`` span, and the kernels
    launched inside those spans give the MoE FFN's device time, its share
    of the step's and its launches per step. Reports "not measured" rather
    than failing if the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.hardware import get_chip
    from repro_torch.models import moe
    from repro_torch.serving.backends import init_torch_params, make_engine
    params = init_torch_params(cfg, 0, device=dev)
    layout = {} if paged is None else {"paged": paged}
    eng = make_engine("torch", 0, cfg, params, slots=slots,
                      capacity=S + 64 + 8, chip=get_chip("h100"), device=dev,
                      **layout)
    name = cfg.name + (" dense" if paged is False else "")
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=gen).numpy()
               for _ in range(slots + 4)]

    class Req:
        slot = engine_id = None

    def report(kind, prof, n, wall_s):
        # the device side's kernels, without the GPU-side copies of the
        # ``moe_ffn`` spans (an annotation, not a kernel)
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and e.name != "moe_ffn"]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
        wall = wall_s * 1e3 / n
        if not kern:
            log(f"# profile {kind}: {wall:.3f} ms per step (host clock); "
                "device time not measured (the profiler saw no kernels)")
            return
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total
                      )[:6]
        log(f"# profile {kind}: {wall:.3f} ms per step (host clock), device "
            f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
            f"{len(kern) / n:.0f} device activities per step; top device "
            "ms per step: "
            + json.dumps([[name[:60], round(ms, 4)] for name, ms in top])
            + "; top host ops, self ms per step (under the profiler): "
            + json.dumps([[a.key[:40], round(a.self_cpu_time_total / 1e3 / n,
                                             4), a.count // n]
                          for a in host]))
        if cfg.moe is None:
            return
        spans = [e for e in prof.events() if e.name == "moe_ffn"
                 and e.device_type == DeviceType.CPU]
        ks = [k for e in spans for k in region_kernels(e)]
        if not ks:
            log(f"# profile {kind}: MoE FFN device time not measured (no "
                "kernel attributed to the moe_ffn spans)")
            return
        moe_ms = sum(ks) / 1e3 / n
        log(f"# profile {kind}: MoE FFN {len(spans) / n:.0f} calls, "
            f"{len(ks) / n:.0f} kernels and {moe_ms:.3f} ms of device time "
            f"per step, {moe_ms / busy:.3f} of device busy")

    orig_ffn = moe.moe_ffn

    def spanned_ffn(*args, **kw):
        with record_function("moe_ffn"):
            return orig_ffn(*args, **kw)

    def profiled(fn):
        """``fn()`` under the profiler, each MoE FFN call in a span."""
        moe.moe_ffn = spanned_ffn
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
        finally:
            moe.moe_ffn = orig_ffn
        return prof

    with torch.inference_mode():
        toks = {}
        for p in prompts[:slots]:
            tok, payload = eng.prefill(p)
            toks[eng.insert(Req(), payload)] = tok
        for _ in range(3):                      # warm-up
            toks = eng.decode_step(toks)
        # host clock without the profiler (it adds host time per op), then
        # the same work again under it for the device side
        t0 = time.perf_counter()
        for _ in range(steps):
            toks = eng.decode_step(toks)
        wall = time.perf_counter() - t0

        def decode_steps():
            nonlocal toks
            for _ in range(steps):
                toks = eng.decode_step(toks)

        report(f"{name} decode (B={slots}, context ~{S + 3 + steps})",
               profiled(decode_steps), steps, wall)
        t0 = time.perf_counter()
        for p in prompts[slots:slots + 2]:
            eng.prefill(p)
        wall = time.perf_counter() - t0

        def prefills():
            for p in prompts[slots + 2:]:
                eng.prefill(p)

        report(f"{name} prefill (S={S})", profiled(prefills), 2, wall)
    del eng, params


def dense_serve(torch, cfg, dev, paged: bool, streams) -> dict:
    """A disaggregated cluster (1 prefill + 1 decode engine, 4 slots) of the
    given layout serving 4 requests of 512/32 at full width, random
    weights from seed 0; records request 0's token stream in
    ``streams[paged]`` and returns the SLA metrics with the step counts."""
    from repro_torch.core.hardware import get_chip
    from repro_torch.serving.backends import init_torch_params, make_engine
    from repro_torch.serving.cluster import Cluster
    from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                       StaticWorkload, materialize)
    params = init_torch_params(cfg, 0, device=dev)
    engines = [make_engine("torch", i, cfg, params, slots=4,
                           capacity=512 + 32 + 8, paged=paged,
                           chip=get_chip("h100"), device=dev)
               for i in (0, 100)]
    reqs = materialize(OpenLoopWorkload(
        Burst(4), FixedShape(512, 32), vocab=cfg.vocab_size, seed=0,
        max_requests=4, horizon_s=3600.0))
    cluster = Cluster({"prefill": engines[:1], "decode": engines[1:]})
    rec = cluster.serve(StaticWorkload(reqs))
    streams[paged] = list(reqs[0].output)
    prefills = sum(e.prefills for e in engines)
    steps = sum(e.decode_steps for e in engines)
    rec.update(mode="dense" if not paged else "paged", prefills=prefills,
               decode_steps=steps, transfers=cluster.stats.transfers,
               transferred_MB=cluster.stats.transferred_bytes / 2**20,
               mean_prefill_step_s=sum(e.prefill_s for e in engines)
               / max(prefills, 1),
               mean_decode_step_s=sum(e.decode_s for e in engines)
               / max(steps, 1))
    del engines, params
    return rec


def check_rwkv_serve(rec, n, cfg, requests: int = 16) -> None:
    """The RWKV serve's checks: every request completes, the WKV kernel
    ran once per layer per prefill and decode step and no attention
    kernel ran, and each handoff carried exactly one request's state."""
    H, N = cfg.num_heads, cfg.dh
    handoff = cfg.num_layers * (H * N * N * 4 + 2 * cfg.d_model
                                * cfg.tdtype.itemsize)
    moved = rec["transferred_MB"] * 2**20
    if rec["completed"] != requests:
        fail(f"rwkv serve completed {rec['completed']} of {requests}")
    if n["wkv"] < cfg.num_layers * (rec["prefills"] + rec["decode_steps"]) \
            or rec["prefills"] < requests or rec["decode_steps"] < 1:
        fail(f"rwkv serve: {n['wkv']} wkv launches for {rec['prefills']} "
             f"prefills and {rec['decode_steps']} decode steps")
    if n["flash"] or n["paged"] or n["dense"]:
        fail(f"rwkv serve launched attention kernels: {n}")
    # a request the elastic matcher leaves on its prefill engine (turned
    # decode) is inserted there and moves nothing
    if abs(moved - rec["transfers"] * handoff) > 0.5 or not (
            rec["transfers"] == requests
            or (rec.get("rate_matcher_moves") and rec["transfers"] < requests)):
        fail(f"rwkv serve moved {moved} bytes in {rec['transfers']} "
             f"transfers; one handoff is {handoff} bytes")
    log(f"# rwkv handoff: {rec['transfers']} x {handoff} bytes = "
        f"{moved:.0f} bytes")


def check_fit(cfg, path, n, kernels) -> dict:
    """Phase 12's checks of one model's fit: its record in the calibration
    table (written by ``calibrate``: scales, measured and predicted
    seconds, step counts), every scale finite and positive, and each of
    ``kernels`` (``{name: per}``, per = "step" for every prefill and decode
    step, "prefill" or "decode") launched at least once per layer per such
    step; every other kernel not at all. Returns the record."""
    with open(path) as f:
        fit = json.load(f)[f"{cfg.name}/gpu-h100"]
    log(f"# fit {cfg.name} on h100: prefill measured "
        f"{fit['measured_prefill_s']:.6f} s, predicted "
        f"{fit['predicted_prefill_s']:.6f} s, scale "
        f"{fit['prefill_scale']:.4f}; decode measured "
        f"{fit['measured_decode_s']:.6f} s, predicted "
        f"{fit['predicted_decode_s']:.6f} s, scale "
        f"{fit['decode_scale']:.4f} ({fit['prefills']} prefills, "
        f"{fit['decode_steps']} decode steps, {fit['device']})")
    for k in ("prefill_scale", "decode_scale"):
        if not (math.isfinite(fit[k]) and fit[k] > 0):
            fail(f"{cfg.name} fit: {k} = {fit[k]}")
    steps = {"prefill": fit["prefills"], "decode": fit["decode_steps"],
             "step": fit["prefills"] + fit["decode_steps"]}
    for name, count in n.items():
        if name in kernels:
            bad = count < cfg.num_layers * steps[kernels[name]]
        else:
            bad = count != 0
        if bad or fit["prefills"] < 2 or fit["decode_steps"] < 2:
            fail(f"{cfg.name} fit: {count} {name} launches for "
                 f"{fit['prefills']} prefills and {fit['decode_steps']} "
                 f"decode steps")
    return fit


def sim_against_real(sim, real, what) -> dict:
    """The simulated serve's p50 FTL, p50 TTL and tokens/s over the real
    serve's; fails unless both latency ratios lie in ``SIM_RATIO``."""
    ratios = {k: sim[k] / real[k] for k in ("p50_ftl_s", "p50_ttl_s",
                                             "tokens_per_s")}
    log(f"# sim / real {what}: " + json.dumps(
        {k: {"sim": sim[k], "real": real[k], "ratio": ratios[k]}
         for k in ratios}))
    lo, hi = SIM_RATIO
    for k in ("p50_ftl_s", "p50_ttl_s"):
        if not lo < ratios[k] < hi:
            fail(f"sim {what}: {k} ratio {ratios[k]} outside ({lo}, {hi})")
    return ratios


def traced_serve(serve, args, out_path):
    """``serve.main(args + --trace-out out_path)`` with ``REPRO_SANITIZE=1``
    for this call only. The launcher's ``Cluster`` is wrapped so the
    cluster (its recorder and sanitizer) and every request it served
    (through a ``workloads.Recorder``) can be checked after it. Returns
    (record, cluster, requests)."""
    from repro_torch.workloads import Recorder
    seen = {}
    base = serve.Cluster

    class Seen(base):
        def serve(self, workload, **kw):
            seen["cluster"], seen["work"] = self, Recorder(workload)
            return super().serve(seen["work"], **kw)

    before = os.environ.get("REPRO_SANITIZE")
    serve.Cluster, os.environ["REPRO_SANITIZE"] = Seen, "1"
    try:
        rec = serve.main(args + ["--trace-out", out_path])
    finally:
        serve.Cluster = base
        if before is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = before
    return rec, seen["cluster"], seen["work"].emitted


def check_trace(cluster, requests, out_path, expected: int) -> None:
    """Phase 14's checks: the trace file is valid trace JSON with one track
    per engine; the sanitizer was on and saw every request arrive and
    complete; each request's phases (``obs.request_phases``) start at its
    arrival, end at its completion and abut, within 1e-9 s."""
    from repro_torch.serving import obs
    with open(out_path) as f:
        trace = json.load(f)
    counts = obs.validate_trace(trace)
    tracks = {(e["pid"], e["tid"]) for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    engines = len(cluster.engines())
    san = cluster.sanitizer
    log(f"# trace: {os.path.getsize(out_path)} bytes, {counts}, "
        f"{len(tracks)} tracks for {engines} engines; sanitizer "
        + ("off" if san is None else
           f"admitted {san.admitted}, completed {san.completed}"))
    if len(tracks) != engines:
        fail(f"trace: {len(tracks)} tracks for {engines} engines")
    if san is None or san.admitted != expected or san.completed != expected:
        fail("traced serve: the sanitizer did not see every request through")
    if len(requests) != expected:
        fail(f"traced serve: {len(requests)} requests of {expected}")
    phases = obs.request_phases(cluster.recorder)
    worst = 0.0
    for r in requests:
        spans = phases[r.rid]
        gaps = [abs(spans[0][1] - r.arrival_t), abs(spans[-1][2] - r.done_t),
                abs(sum(t1 - t0 for _, t0, t1 in spans) - r.e2e_s)]
        gaps += [abs(a[2] - b[1]) for a, b in zip(spans, spans[1:])]
        worst = max(worst, max(gaps))
    log(f"# trace: phases of {len(requests)} requests tile [arrival, done] "
        f"within {worst:.3e} s")
    if not worst <= 1e-9:
        fail(f"trace: request phases do not tile e2e ({worst} s)")


def sim_phases(torch, serve, drive, sla, dev, scratch, weights, real, cfgs):
    """Phases 12-14: the simulator fitted on the card and served against
    the real serves of phases 5 and 10, then phase 5's serve traced with
    the sanitizer on, and a trace replayed at full width."""
    from repro_torch.core.hardware import get_chip
    from repro_torch.serving.simengine import calibrate
    cal_path = os.path.join(scratch, "calibration.json")
    arch = {"qwen": [], "rwkv": ["--arch", "rwkv6-1.6b"]}
    # the kernels each model's fit must launch, per layer per step of a kind
    fit_kernels = {"qwen": {"flash": "prefill", "paged": "decode"},
                   "rwkv": {"wkv": "step"}}

    # 12) calibrate: the roofline's scale fitted through the kernel path
    t_phase = time.perf_counter()
    for m in ("qwen", "rwkv"):
        _, n = drive(f"calibrate-{m}", lambda m=m: calibrate(
            cfgs[m], weights[m], chip=get_chip("h100"), isl=512, osl=64,
            batch=8, n_prompts=8, path=cal_path, device=dev))
        check_fit(cfgs[m], cal_path, n, fit_kernels[m])
    # the launcher's own flag, at its default fit shape (48/8, 2 slots);
    # at full width: the smoke configuration's 16-wide heads are not a
    # shape the attention kernels take (they take dh = 128)
    cli_path = os.path.join(scratch, "cli_calibration.json")
    rec, n = drive("calibrate-cli", lambda: serve.main(
        ["--backend", "sim", "--calibrate", "--requests", "4",
         "--calibration-path", cli_path]))
    check_fit(cfgs["qwen"], cli_path, n, fit_kernels["qwen"])
    if rec["completed"] != 4:
        fail(f"sim serve after --calibrate: {rec['completed']} of 4")
    log(f"# phase calibrate: {time.perf_counter() - t_phase:.1f} s")

    # 13) sim serve: the simulator on the fitted clock, phase 5's and 10's
    #     traffic, against their real serves
    t_phase = time.perf_counter()
    for m in ("qwen", "rwkv"):
        rec, n = drive(f"sim-{m}", lambda m=m: serve.main(
            arch[m] + SERVE_ARGS + ["--backend", "sim", "--calibration-path",
                                    cal_path]))
        sla(rec)
        if rec["completed"] != 16 or any(n.values()):
            fail(f"sim serve {m}: completed {rec['completed']} of 16, "
                 f"launches {n}")
        sim_against_real(rec, real[m], cfgs[m].name)
    log(f"# phase sim serve: {time.perf_counter() - t_phase:.1f} s")

    # 14) traced serve: phase 5 again under the recorder and the sanitizer,
    #     then a corpus trace replayed at full width
    t_phase = time.perf_counter()
    out_path = os.path.join(scratch, "trace.json")
    (rec, cluster, reqs), n = drive("traced", lambda: traced_serve(
        serve, SERVE_ARGS, out_path))
    sla(rec)
    Lr = cfgs["qwen"].num_layers
    if rec["completed"] != 16 or n["flash"] < Lr * rec["prefills"] \
            or n["paged"] < Lr * rec["decode_steps"]:
        fail(f"traced serve: completed {rec['completed']} of 16, "
             f"launches {n}")
    check_trace(cluster, reqs, out_path, 16)
    del cluster, reqs
    log("# traced / untraced mean step s: " + json.dumps(
        {k: [rec[k], real["qwen"][k]]
         for k in ("mean_prefill_step_s", "mean_decode_step_s")}))
    burst = os.path.join(ROOT, "tests", "data", "traces", "burst.jsonl")
    rec, n = drive("trace-replay", lambda: serve.main(["--trace", burst]))
    sla(rec)
    if rec["completed"] != 10 or rec["workload"] != "trace" \
            or n["flash"] < Lr * rec["prefills"]:
        fail(f"trace replay: completed {rec['completed']} of 10, "
             f"launches {n}")
    log(f"# phase traced serve: {time.perf_counter() - t_phase:.1f} s")


def dense14b_model_phase(torch, dev, gen, get_config) -> None:
    """Phase 15: ``model_phase`` on each 14B configuration at full width
    and depth, the float32 reference one block at a time; each model's
    weights freed before the next."""
    for arch in HEADS_14B:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model_phase(torch, cfg, dev, gen)
        torch.cuda.synchronize()
        log(f"# phase model {arch} ({cfg.num_layers} layers, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads, G = {cfg.q_group}, "
            f"{n_params(params) / 1e9:.2f} B parameters): "
            f"{time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params
        torch.cuda.empty_cache()


def dense14b_serves(serve, drive, sla, get_config) -> None:
    """Phase 16: each 14B configuration served with phase 5's traffic;
    every prefill through flash and every decode step (and each of the 3
    engines' warm-up steps) through paged decode, once per layer exactly,
    and no other kernel."""
    engines = 3                 # SERVE_ARGS: 1 prefill + 2 decode engines
    for arch in HEADS_14B:
        cfg = get_config(arch)
        Lr = cfg.num_layers
        rec, n = drive(f"serve-{arch}", lambda arch=arch: serve.main(
            ["--arch", arch] + SERVE_ARGS))
        sla(rec)
        if rec["completed"] != 16:
            fail(f"{arch} serve completed {rec['completed']} of 16")
        if n["flash"] != Lr * rec["prefills"] or rec["prefills"] < 16:
            fail(f"{arch} serve: {n['flash']} flash launches for "
                 f"{rec['prefills']} prefills of {Lr} layers")
        if n["paged"] != Lr * (rec["decode_steps"] + engines) \
                or rec["decode_steps"] < 1:
            fail(f"{arch} serve: {n['paged']} paged launches for "
                 f"{rec['decode_steps']} decode steps + {engines} warm-ups "
                 f"of {Lr} layers")
        if n["dense"] or n["wkv"]:
            fail(f"{arch} serve launched dense decode or WKV: {n}")
        log(f"# {arch} serve (G = {cfg.q_group}): flash {n['flash']} = "
            f"{Lr} x {rec['prefills']} prefills, paged {n['paged']} = {Lr} x "
            f"({rec['decode_steps']} decode steps + {engines} warm-ups)")


def granite_model_phase(torch, dev, gen, get_config) -> None:
    """Phase 18: ``model_phase`` on granite-moe-1b-a400m at full width and
    depth (24 layers, 16/8 heads of 64, 32 experts top-8), the float32
    reference upcast one block at a time, with each step's MoE routing
    reported (flips against the reference, drops per prefill)."""
    cfg = get_config(GRANITE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RoutingTap() as tap:
        params = model_phase(torch, cfg, dev, gen, tap=tap)
    torch.cuda.synchronize()
    log(f"# phase model {GRANITE} ({cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.dh}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
        f"{n_params(params) / 1e9:.3f} B parameters): "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()


def granite_serve(serve, drive, sla, get_config) -> dict:
    """Phase 19: granite-moe-1b-a400m served with phase 5's traffic; every
    prefill through flash and every decode step (and each of the 3
    engines' warm-up steps) through paged decode, once per layer exactly,
    at dh = 64; no other kernel; each handoff one 512-token prompt's
    blocks, 24 x 64 blocks x 8 rows x 8 heads x 64 x 2 (K, V) x 2 bytes =
    24 MiB."""
    cfg = get_config(GRANITE)
    Lr, engines, requests = cfg.num_layers, 3, 16
    rec, n = drive("serve-granite", lambda: serve.main(
        ["--arch", GRANITE] + SERVE_ARGS))
    sla(rec)
    if rec["completed"] != requests:
        fail(f"granite serve completed {rec['completed']} of {requests}")
    if n["flash"] != Lr * rec["prefills"] or rec["prefills"] < requests:
        fail(f"granite serve: {n['flash']} flash launches for "
             f"{rec['prefills']} prefills of {Lr} layers")
    if n["paged"] != Lr * (rec["decode_steps"] + engines) \
            or rec["decode_steps"] < 1:
        fail(f"granite serve: {n['paged']} paged launches for "
             f"{rec['decode_steps']} decode steps + {engines} warm-ups of "
             f"{Lr} layers")
    if n["dense"] or n["wkv"]:
        fail(f"granite serve launched dense decode or WKV: {n}")
    handoff = 512 * cfg.kv_bytes_per_token()
    moved = rec["transferred_MB"] * 2**20
    # a request the elastic matcher leaves on its prefill engine (turned
    # decode) is inserted there and moves nothing
    if handoff != 24 * 2**20 or abs(moved - rec["transfers"] * handoff) > 0.5 \
            or not (rec["transfers"] == requests
                    or (rec.get("rate_matcher_moves")
                        and rec["transfers"] < requests)):
        fail(f"granite serve moved {moved} bytes in {rec['transfers']} "
             f"transfers; one handoff is {handoff} bytes")
    log(f"# {GRANITE} serve: flash {n['flash']} = {Lr} x {rec['prefills']} "
        f"prefills, paged {n['paged']} = {Lr} x ({rec['decode_steps']} "
        f"decode steps + {engines} warm-ups); {rec['transfers']} handoffs x "
        f"{handoff} bytes")
    return rec


def sweep_phase(scratch) -> None:
    """Phase 17: the design-space sweep as a subprocess on the host (no
    CUDA device visible to it or its workers), then again on the same
    store, which must be all cache hits."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    store = os.path.join(scratch, "sweeps")
    reports = []
    for run in ("first", "rerun"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.sweep", *SWEEP_ARGS,
             "--store", store], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"sweep {run}: exit {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        rep = json.loads(proc.stdout)
        log(f"# sweep {run}: {wall:.2f} s host wall for the subprocess; "
            f"report: " + json.dumps(rep))
        reports.append(rep)
    first, rerun = reports
    if (first["spec_hash"], first["points"], first["cells_total"],
            first["cells_run"]) != (SWEEP_HASH, SWEEP_POINTS, SWEEP_CELLS,
                                    SWEEP_CELLS):
        fail(f"sweep: spec_hash {first['spec_hash']}, {first['points']} "
             f"points in {first['cells_run']} of {first['cells_total']} "
             f"cells; expected {SWEEP_HASH}, {SWEEP_POINTS} in "
             f"{SWEEP_CELLS}")
    if (rerun["cells_cached"], rerun["cells_total"], rerun["cells_run"]) \
            != (SWEEP_CELLS, SWEEP_CELLS, 0) \
            or rerun["points"] != first["points"] \
            or rerun["records"] != first["records"] \
            or rerun["frontier_areas"] != first["frontier_areas"]:
        fail(f"sweep rerun: {rerun['cells_cached']} of "
             f"{rerun['cells_total']} cached, {rerun['cells_run']} run")
    log(f"# sweep: spec_hash {first['spec_hash']}, {first['points']} points "
        f"in {first['cells_total']} cells, {first['records']} records, "
        f"{first['points_per_s']} points/s over {first['elapsed_s']} s "
        f"(host); rerun {rerun['cells_cached']} of {rerun['cells_total']} "
        f"cells cached in {rerun['elapsed_s']} s")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"# card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    # 2) build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"# build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(_build.build_logs.items()):
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = ptxas_entry(line)
            elif "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"# ptxas {name} {entry}: "
                    f"{line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(torch)
    rows = {}

    # 3a) flash attention: main path shapes, ragged, q_offset
    t0 = time.perf_counter()
    fl_err = 0.0
    # the last two: the longer shape timed below, and a ragged B=2 one
    for (B, Sq, Skv, H, Hkv, off) in [(1, 512, 512, 16, 2, 0),
                                       (1, 509, 509, 16, 2, 0),
                                       (1, 128, 512, 16, 2, 384),
                                       (2, 96, 96, 16, 2, 0),
                                       (1, 4096, 4096, 16, 2, 0),
                                       (2, 1100, 1177, 16, 2, 77)]:
        q, k, v = flash_case(torch, gen, B, Sq, Skv, H, Hkv, dev)
        out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"# flash B={B} Sq={Sq} Skv={Skv} off={off}: max_abs_err "
            f"{err:.3e}")
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"flash attention disagrees with its plain version: {err}")
        fl_err = max(fl_err, err)
    q, k, v = flash_case(torch, gen, 1, 256, 256, 16, 2, dev)
    out = fl_ops.flash_attention(q, k, v, causal=False)
    err = (out.float() - flash_attention_ref(q, k, v, causal=False).float()
           ).abs().max().item()
    log(f"# flash non-causal 256: max_abs_err {err:.3e}")
    if not err <= KERNEL_ATOL:
        fail(f"non-causal flash attention disagrees: {err}")
    fl_err = max(fl_err, err)

    def time_flash(S, H=16, Hkv=2, dh=128):
        flops, nbytes = flash_work(1, S, S, H, Hkv, 0, dh)
        cases = [flash_case(torch, gen, 1, S, S, H, Hkv, dev, dh)
                 for _ in range(copies(nbytes))]
        lib_cases = [tuple(x.transpose(1, 2) for x in c) for c in cases]

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        res = {
            "ms": timer(fl_ops.flash_attention, cases),
            "device_ms": timer.device(fl_ops.flash_attention, cases),
            "plain_ms": timer(flash_attention_ref, cases, runs=3),
            "library_ms": timer(sdpa, lib_cases),
            "library_device_ms": timer.device(sdpa, lib_cases),
        }
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
        log(f"# flash time S={S} H={H} Hkv={Hkv} dh={dh} ({len(cases)} input "
            "sets): " + json.dumps(res))
        return res

    rows["flash"] = time_flash(512)
    time_flash(4096)

    # 3b) paged decode: main path shapes (engine block_size 8), garbage
    lengths = lengths_mixed = [577, 100, 1, 64, 300, 512, 9, 250]
    q, pk, pv, tbl, lens = paged_case(torch, gen, lengths, 8, 16, 2, dev)
    out = dec_ops.decode_attention_paged(q, pk, pv, tbl, lens)
    torch.cuda.synchronize()
    ref = dec_ops.decode_attention_paged_plain(q, pk, pv, tbl, lens)
    dec_err = (out.float() - ref.float()).abs().max().item()
    log(f"# paged B=8 Bs=8 lengths={lengths}: max_abs_err {dec_err:.3e}")
    if not math.isfinite(dec_err) or dec_err > KERNEL_ATOL:
        fail(f"paged decode disagrees with its plain version: {dec_err}")
    pk2, pv2 = pk.clone(), pv.clone()
    pk2[0], pv2[0] = 1e4, -1e4
    for b, n in enumerate(lengths):
        if n % 8:
            last = int(tbl[b, (n - 1) // 8])
            pk2[last, n % 8:] = 77.0
            pv2[last, n % 8:] = -77.0
    out2 = dec_ops.decode_attention_paged(q, pk2, pv2, tbl, lens)
    g_err = (out2.float() - out.float()).abs().max().item()
    log(f"# paged garbage-block immunity: max change {g_err:.3e}")
    if g_err > 1e-6:
        fail(f"poisoned trash/tail blocks leaked into the output: {g_err}")

    def time_paged(lengths, nb=None, H=16, Hkv=2, dh=128):
        first = paged_case(torch, gen, lengths, 8, H, Hkv, dev, nb, dh)
        nbytes = 2 * first[1].numel() * first[1].element_size()  # K, V
        cases = [first] + [paged_case(torch, gen, lengths, 8, H, Hkv, dev,
                                      nb, dh)
                           for _ in range(copies(nbytes) - 1)]
        tbl = first[3]
        parts = timer.device_by_kernel(dec_ops.decode_attention_paged, cases)
        res = {
            "ms": timer(dec_ops.decode_attention_paged, cases),
            **split_and_merge(parts, "paged_decode_kernel"),
            "plain_ms": timer(dec_ops.decode_attention_paged_plain, cases,
                              runs=3),
            "library_ms": None,     # PyTorch has no paged attention call
        }
        res["bound_ms"], res["bound_by"] = bound(*paged_work(
            lengths, len(lengths), tbl.shape[1], H, Hkv, dh))
        log(f"# paged time B={len(lengths)} max_len={max(lengths)} "
            f"nb={tbl.shape[1]} H={H} Hkv={Hkv} dh={dh} ({len(cases)} input "
            "sets): "
            + json.dumps(res) + "; device ms by kernel: "
            + json.dumps({name[:50]: t for name, t in parts.items()}))
        return res

    # the serve phase's decode step: 8 slots midway through 64 new tokens
    # after a 512-token prompt; the engine's window is capped at its
    # capacity, ceil((512 + 64 + 8) / 8) = 73 blocks
    rows["paged"] = time_paged([544] * 8, nb=73)
    time_paged(lengths)
    time_paged([4096] * 32)

    # 3b') flash and paged decode at the 14B configurations' heads: against
    #      their plain versions at the serve's prefill, ragged and chunk
    #      shapes (flash) and mixed lengths (paged), then timed at phase
    #      16's shapes
    for arch, (H, Hkv) in HEADS_14B.items():
        for (B, Sq, Skv, off) in [(1, 512, 512, 0), (1, 509, 509, 0),
                                  (2, 70, 300, 230), (1, 1, 449, 448),
                                  (1, 16, 464, 448), (1, 64, 576, 512)]:
            q, k, v = flash_case(torch, gen, B, Sq, Skv, H, Hkv, dev)
            out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"# flash {arch} H={H} Hkv={Hkv} B={B} Sq={Sq} Skv={Skv} "
                f"off={off}: max_abs_err {err:.3e}")
            if not math.isfinite(err) or err > KERNEL_ATOL:
                fail(f"flash at {arch}'s heads disagrees: {err}")
            fl_err = max(fl_err, err)
        q, pk, pv, tbl, lens = paged_case(torch, gen, lengths, 8, H, Hkv,
                                          dev)
        out = dec_ops.decode_attention_paged(q, pk, pv, tbl, lens)
        torch.cuda.synchronize()
        err = (out.float() - dec_ops.decode_attention_paged_plain(
            q, pk, pv, tbl, lens).float()).abs().max().item()
        log(f"# paged {arch} H={H} Hkv={Hkv} lengths={lengths}: "
            f"max_abs_err {err:.3e}")
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"paged decode at {arch}'s heads disagrees: {err}")
        dec_err = max(dec_err, err)
        rows["flash"].setdefault("shapes_14b", {})[arch] = time_flash(
            512, H, Hkv)
        rows["paged"].setdefault("shapes_14b", {})[arch] = time_paged(
            [544] * 8, nb=73, H=H, Hkv=Hkv)
    log(f"# phase kernels (flash, paged): {time.perf_counter() - t0:.1f} s")

    # 3c) flash attention at chunked-prefill shapes: Sq < 64 and offsets
    #     that are no multiple of the 64-row tile, Skv = q_offset + Sq
    t0 = time.perf_counter()
    chunk_rows = []
    for Sq, off in [(16, 48), (16, 448), (64, 48), (64, 448)]:
        Skv = off + Sq
        q, k, v = flash_case(torch, gen, 1, Sq, Skv, 16, 2, dev)
        out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
        err = (out.float() - ref.float()).abs().max().item()
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"flash at chunk Sq={Sq} q_offset={off} disagrees: {err}")
        fl_err = max(fl_err, err)
        flops, nbytes = flash_work(1, Sq, Skv, 16, 2, off)
        cases = [flash_case(torch, gen, 1, Sq, Skv, 16, 2, dev)
                 for _ in range(copies(nbytes))]
        mask = (torch.arange(Skv, device=dev)[None, :]
                <= off + torch.arange(Sq, device=dev)[:, None])
        lib_cases = [tuple(x.transpose(1, 2) for x in c) for c in cases]

        def kernel(q, k, v, off=off):
            return fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)

        def sdpa(q, k, v, mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        res = {"Sq": Sq, "q_offset": off, "Skv": Skv, "max_abs_err": err,
               "ms": timer(kernel, cases),
               "device_ms": timer.device(kernel, cases),
               "plain_ms": timer(lambda q, k, v: flash_attention_ref(
                   q, k, v, causal=True, q_offset=off), cases, runs=3),
               "library_ms": timer(sdpa, lib_cases),
               "library_device_ms": timer.device(sdpa, lib_cases)}
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
        log("# flash chunk time: " + json.dumps(res))
        chunk_rows.append(res)
    rows["flash"]["chunk_shapes"] = chunk_rows

    # 3d) dense decode (kernel 3): the dense engine's capacity 584 (no
    #     multiple of the split), mixed lengths including 1 and Smax, then
    #     rows at and past each length poisoned with +-1e4; then the edges
    #     of the 32-, 48- and 64-row splits
    Smax = 584
    lengths = [1, 584, 100, 128, 129, 300, 512, 9]
    q, kc, vc, lens = dense_case(torch, gen, lengths, Smax, 16, 2, dev)
    out = dec_ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, kc, vc, lens)
    dense_err = (out.float() - ref.float()).abs().max().item()
    log(f"# dense B=8 Smax={Smax} lengths={lengths}: max_abs_err "
        f"{dense_err:.3e}")
    if not math.isfinite(dense_err) or dense_err > KERNEL_ATOL:
        fail(f"dense decode disagrees with its plain version: {dense_err}")
    kc2, vc2 = kc.clone(), vc.clone()
    for b, n in enumerate(lengths):
        kc2[b, n:], vc2[b, n:] = 1e4, -1e4
    out2 = dec_ops.decode_attention(q, kc2, vc2, lens)
    torch.cuda.synchronize()
    if not torch.equal(out, out2):
        fail("dense decode: rows at or past a length leaked into the "
             f"output ({(out2.float() - out.float()).abs().max().item()})")
    log("# dense length-mask exactness: output unchanged with rows at and "
        "past each length poisoned to +-1e4")
    dense_err = max(dense_err, dense_split_edges(torch, dev, gen, dec_ops,
                                                 decode_attention_ref))

    def time_dense(lengths, Smax, H=16, Hkv=2, dh=128):
        B = len(lengths)
        first = dense_case(torch, gen, lengths, Smax, H, Hkv, dev, dh)
        nbytes = 2 * first[1].numel() * first[1].element_size()
        cases = [first] + [dense_case(torch, gen, lengths, Smax, H, Hkv, dev,
                                      dh)
                           for _ in range(copies(nbytes) - 1)]
        cols = torch.arange(Smax, device=dev)

        def sdpa(q, k, v, lens):
            keep = (cols[None, :] < lens[:, None].long())[:, None, None, :]
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=keep, enable_gqa=True)

        parts = timer.device_by_kernel(dec_ops.decode_attention, cases)
        res = {"ms": timer(dec_ops.decode_attention, cases),
               **split_and_merge(parts, "dense_decode_kernel"),
               "plain_ms": timer(decode_attention_ref, cases, runs=3),
               "library_ms": timer(sdpa, cases),
               "library_device_ms": timer.device(sdpa, cases)}
        res["bound_ms"], res["bound_by"] = bound(*dense_work(lengths, B, H,
                                                             Hkv, dh))
        log(f"# dense time B={B} Smax={Smax} max_len={max(lengths)} H={H} "
            f"Hkv={Hkv} dh={dh} split={dec_ops.split_tokens(B, Hkv, Smax)} "
            f"({len(cases)} input sets): " + json.dumps(res))
        return res

    # the dense serve's decode step: 8 slots midway through 64 new tokens
    # after a 512-token prompt, in the launcher's capacity of 584
    rows["dense"] = time_dense([544] * 8, 584)
    time_dense(lengths, 584)
    time_dense([4096] * 32, 4096)
    log(f"# phase kernels (flash chunks, dense): "
        f"{time.perf_counter() - t0:.1f} s")

    # 3e) head dim 64 at granite-moe-1b-a400m's heads (16/8, G = 2): flash
    #     at the serve's prefill, ragged, chunk and B = 2 shapes; paged and
    #     dense decode at mixed lengths, split edges and the serve's step,
    #     each with poisoned rows; then each timed at the serve's shape
    t0 = time.perf_counter()
    H, Hkv = HEADS_GRANITE
    errs = {"flash": 0.0, "paged": 0.0, "dense": 0.0}
    for (B, Sq, Skv, off) in [(1, 512, 512, 0), (1, 509, 509, 0),
                              (2, 70, 300, 230), (2, 96, 96, 0),
                              (1, 1, 449, 448), (1, 16, 464, 448),
                              (1, 64, 112, 48), (1, 64, 576, 512)]:
        q, k, v = flash_case(torch, gen, B, Sq, Skv, H, Hkv, dev, 64)
        out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"# flash dh=64 H={H} Hkv={Hkv} B={B} Sq={Sq} Skv={Skv} "
            f"off={off}: max_abs_err {err:.3e}")
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"flash at dh 64 disagrees: {err}")
        errs["flash"] = max(errs["flash"], err)
    for lens_g, nb in [(lengths_mixed, None), ([1, 32, 33, 63, 97, 544, 584,
                                                9], 73)]:
        q, pk, pv, tbl, lens = paged_case(torch, gen, lens_g, 8, H, Hkv, dev,
                                          nb, 64)
        out = dec_ops.decode_attention_paged(q, pk, pv, tbl, lens)
        torch.cuda.synchronize()
        err = (out.float() - dec_ops.decode_attention_paged_plain(
            q, pk, pv, tbl, lens).float()).abs().max().item()
        pk2, pv2 = pk.clone(), pv.clone()
        pk2[0], pv2[0] = 1e4, -1e4
        for b, n in enumerate(lens_g):
            if n % 8:
                last = int(tbl[b, (n - 1) // 8])
                pk2[last, n % 8:], pv2[last, n % 8:] = 77.0, -77.0
        same = torch.equal(out, dec_ops.decode_attention_paged(
            q, pk2, pv2, tbl, lens))
        log(f"# paged dh=64 H={H} Hkv={Hkv} lengths={lens_g} nb="
            f"{tbl.shape[1]}: max_abs_err {err:.3e}, poisoned blocks "
            f"{'bit-unchanged' if same else 'LEAKED'}")
        if not math.isfinite(err) or err > KERNEL_ATOL or not same:
            fail(f"paged decode at dh 64 disagrees ({err}) or leaks ({same})")
        errs["paged"] = max(errs["paged"], err)
    for B, Smax in [(8, 584), (4, 100)]:
        T = dec_ops.split_tokens(B, Hkv, Smax)
        lens_g = [0, 1, T, T + 1, Smax, Smax + 5, 2 * T - 1, 77][:B]
        q, kc, vc, lens = dense_case(torch, gen, lens_g, Smax, H, Hkv, dev, 64)
        out = dec_ops.decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        err = (out.float() - decode_attention_ref(q, kc, vc, lens).float()
               ).abs().max().item()
        kc2, vc2 = kc.clone(), vc.clone()
        for b, n in enumerate(lens_g):
            kc2[b, n:], vc2[b, n:] = 1e4, -1e4
        same = torch.equal(out, dec_ops.decode_attention(q, kc2, vc2, lens))
        log(f"# dense dh=64 H={H} Hkv={Hkv} B={B} Smax={Smax} split={T} "
            f"lengths={lens_g}: max_abs_err {err:.3e}, poisoned rows "
            f"{'bit-unchanged' if same else 'LEAKED'}")
        if not math.isfinite(err) or err > KERNEL_ATOL or not same:
            fail(f"dense decode at dh 64 disagrees ({err}) or leaks ({same})")
        errs["dense"] = max(errs["dense"], err)
    for key, row in (("flash", time_flash(512, H, Hkv, 64)),
                     ("paged", time_paged([544] * 8, nb=73, H=H, Hkv=Hkv,
                                          dh=64)),
                     ("dense", time_dense([544] * 8, 584, H, Hkv, 64))):
        rows[key]["granite_dh64"] = {"max_abs_err": errs[key], **row}
    fl_err, dec_err = max(fl_err, errs["flash"]), max(dec_err, errs["paged"])
    dense_err = max(dense_err, errs["dense"])
    log(f"# phase kernels (dh 64): {time.perf_counter() - t0:.1f} s")

    # 3f) WKV (kernel 4)
    t0 = time.perf_counter()
    wkv_err, rows["wkv"] = wkv_phase(torch, dev, gen, timer)
    log(f"# phase kernels (wkv): {time.perf_counter() - t0:.1f} s")

    # 4) model: full-width qwen2.5-3b, kernel path vs plain path vs fp32
    cfg = get_config("qwen2.5-3b")
    weights = {"qwen": model_phase(torch, cfg, dev, gen)}
    torch.cuda.empty_cache()

    counters = {"flash": fl_ops.flash_attention,
                "paged": dec_ops.decode_attention_paged,
                "dense": dec_ops.decode_attention,
                "wkv": wkv_ops.wkv}
    by_path = {}

    def drive(path, fn):
        """Run one path with every launch count set to 0 just before it and
        read just after; returns (its result, its launch counts). What an
        earlier path left in reference cycles (its engines, its weights) is
        collected first, so the peak memory printed is this path's."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        n = {name: c.launches for name, c in counters.items()}
        by_path[path] = n
        log(f"# phase {path}: {time.perf_counter() - t0:.1f} s wall, "
            f"launches {n}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return out, n

    def sla(rec):
        sim = " sim" if rec.get("backend") == "sim" else ""
        log(f"# {rec['mode']}{sim} sla: " + json.dumps(
            {k: rec.get(k) for k in (
                "completed", "prefills", "decode_steps", "p50_ftl_s",
                "p99_ftl_s", "p50_ttl_s", "p99_ttl_s", "tokens_per_s",
                "transfers", "transferred_MB", "rate_matcher_moves",
                "prefix_hits", "mean_prefill_step_s",
                "mean_decode_step_s")}))

    # 5) disaggregated serve, the port's entry point
    Lr = cfg.num_layers
    real = {}
    rec, n = drive("disagg", lambda: serve.main(SERVE_ARGS))
    real["qwen"] = rec
    sla(rec)
    if rec["completed"] != 16:
        fail(f"serve completed {rec['completed']} of 16")
    if n["flash"] < Lr * rec["prefills"] or rec["prefills"] < 16:
        fail(f"flash kernel: {n['flash']} launches for {rec['prefills']} "
             "prefills")
    if n["paged"] < Lr * rec["decode_steps"] or rec["decode_steps"] < 1:
        fail(f"paged kernel: {n['paged']} launches for "
             f"{rec['decode_steps']} decode steps")

    # 6) co-located serve: chunked prefill with decode piggybacked
    rec, n = drive("coloc", lambda: serve.main(
        ["--mode", "coloc", "--requests", "8", "--isl", "512", "--osl", "64",
         "--slots", "8", "--prefill-engines", "1", "--decode-engines", "1",
         "--piggyback-chunk", "64", "--rate-matcher", "none"]))
    sla(rec)
    if rec["completed"] != 8 or rec["transfers"] != 0:
        fail(f"coloc serve: completed {rec['completed']} of 8, transfers "
             f"{rec['transfers']}")
    if n["flash"] < Lr * 8 * (512 // 64):
        fail(f"coloc: {n['flash']} flash launches for 8 prompts of 8 chunks")
    if n["paged"] < Lr * rec["decode_steps"] or rec["decode_steps"] < 1:
        fail(f"coloc: {n['paged']} paged launches for "
             f"{rec['decode_steps']} decode steps")

    # 7) prefix-affinity serve over multi-turn sessions
    rec, n = drive("prefix", lambda: serve.main(
        ["--mode", "coloc", "--scheduler", "prefix-affinity", "--workload",
         "sessions", "--requests", "2", "--turns", "2", "--isl", "256",
         "--osl", "16", "--piggyback-chunk", "64", "--rate-matcher",
         "none"]))
    sla(rec)
    if rec["completed"] != 4 or rec["prefix_hits"] <= 0:
        fail(f"prefix-affinity serve: completed {rec['completed']} of 4, "
             f"prefix hits {rec['prefix_hits']}")
    if n["flash"] < Lr or n["paged"] < Lr * rec["decode_steps"]:
        fail(f"prefix-affinity serve: launches {n}")

    # 8) dense layout: a disaggregated cluster of paged=False engines
    streams = {}
    rec, n = drive("dense", lambda: dense_serve(torch, cfg, dev, False,
                                                streams))
    sla(rec)
    if rec["completed"] != 4:
        fail(f"dense serve completed {rec['completed']} of 4")
    if n["dense"] < Lr * rec["decode_steps"] or rec["decode_steps"] < 1 \
            or n["paged"] != 0:
        fail(f"dense serve: launches {n} for {rec['decode_steps']} decode "
             "steps")
    t0 = time.perf_counter()
    dense_serve(torch, cfg, dev, True, streams)     # not counted
    d, p = streams[False], streams[True]
    agree = next((i for i, (a, b) in enumerate(zip(d, p)) if a != b),
                 min(len(d), len(p)))
    log(f"# dense vs paged, request 0: first {agree} of {len(d)} tokens "
        f"agree ({time.perf_counter() - t0:.1f} s for the paged run)")

    # 9) RWKV-6 model: full-width rwkv6-1.6b, kernel vs plain vs fp32
    rwkv = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    weights["rwkv"] = rwkv_model_phase(torch, rwkv, dev, gen)
    torch.cuda.empty_cache()
    log(f"# phase rwkv model: {time.perf_counter() - t0:.1f} s")

    # 10) RWKV-6 serve: disaggregated, the state handed over
    rec, n = drive("rwkv", lambda: serve.main(
        ["--arch", "rwkv6-1.6b"] + SERVE_ARGS))
    real["rwkv"] = rec
    sla(rec)
    check_rwkv_serve(rec, n, rwkv)

    # 11) profile: where a prefill and a decode step spend their time
    t0 = time.perf_counter()
    profile_phase(torch, cfg, dev)
    profile_phase(torch, cfg, dev, paged=False)
    profile_phase(torch, rwkv, dev)
    log(f"# phase profile: {time.perf_counter() - t0:.1f} s")

    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sim_phases(torch, serve, drive, sla, dev, scratch, weights, real,
                   {"qwen": cfg, "rwkv": rwkv})
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    del weights
    torch.cuda.empty_cache()

    # 15) the 14B models: full width and depth, kernel vs plain vs fp32
    t0 = time.perf_counter()
    dense14b_model_phase(torch, dev, gen, get_config)
    log(f"# phase 14B models: {time.perf_counter() - t0:.1f} s")

    # 16) the 14B serves: phase 5's traffic at 40 layers
    t0 = time.perf_counter()
    dense14b_serves(serve, drive, sla, get_config)
    log(f"# phase 14B serves: {time.perf_counter() - t0:.1f} s")

    # 17) the design-space sweep on the host
    t0 = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        sweep_phase(scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"# phase sweep: {time.perf_counter() - t0:.1f} s")

    # 18) granite-moe-1b-a400m: full width and depth, kernel vs plain vs
    #     fp32, with the MoE routing of each path
    t0 = time.perf_counter()
    granite_model_phase(torch, dev, gen, get_config)
    log(f"# phase granite model: {time.perf_counter() - t0:.1f} s")

    # 19) granite served disaggregated: phase 5's traffic, dh 64 kernels
    t0 = time.perf_counter()
    granite_serve(serve, drive, sla, get_config)
    log(f"# phase granite serve: {time.perf_counter() - t0:.1f} s")

    # 20) granite profile: a decode step of 8 slots and a 512-token
    #     prefill, with the MoE FFN's share of the device time
    t0 = time.perf_counter()
    profile_phase(torch, get_config(GRANITE), dev)
    log(f"# phase granite profile: {time.perf_counter() - t0:.1f} s")

    def total(name):
        return sum(n[name] for n in by_path.values())

    source = "src/repro_torch/kernels/{}/csrc/{}.cu"
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": source.format("flash_attention", "flash_attention"),
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:81",
         "launches": total("flash"), "max_abs_err": fl_err,
         **rows["flash"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": source.format("decode_attention", "paged_decode"),
         "replaces": "src/repro/kernels/decode_attention/paged_decode.py:74",
         "launches": total("paged"), "max_abs_err": dec_err,
         **rows["paged"]},
        {"name": "decode_attention", "route": "cuda",
         "source": source.format("decode_attention", "decode_attention"),
         "replaces":
             "src/repro/kernels/decode_attention/decode_attention.py:68",
         "launches": total("dense"), "max_abs_err": dense_err,
         **rows["dense"]},
        {"name": "wkv", "route": "cuda",
         "source": source.format("rwkv6", "wkv"),
         "replaces": "src/repro/kernels/rwkv6/rwkv6.py:78",
         "launches": total("wkv"), "max_abs_err": wkv_err, **rows["wkv"]},
    ]
    for k, key in zip(kernels, ("flash", "paged", "dense", "wkv")):
        k["launches_by_path"] = {path: n[key] for path, n in by_path.items()}
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
