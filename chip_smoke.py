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
     plain chunked version (no PyTorch call computes the recurrence); the
     selective-scan kernel (the SSM mixers' prompt scan) against its plain
     chunked version (``ssm._scan``) at Jamba's prefill shapes (S = 1,024
     and 2,048 at d_inner 8,192, a delta per channel) and hymba's (S =
     512 at 1,600, one shared delta), from a nonzero state, within
     SCAN_RTOL of each row's norm, then timed beside the plain scan and
     the bound (no PyTorch call computes the recurrence); the MoE FFN
     alone at the jamba cell's shapes (one layer: d 4,096, 8 held of 16
     experts of 14,336, top-2, prompts of 256 to 2,048 tokens) and the
     granite cell's (d 1,024, 32 experts of 512, top-8, prompts of 2,048
     to 32,768), the grouped dispatch against the padded one within
     MOE_RTOL of the output's scale and relaunched bit-equal, both timed
     by CUDA events beside the bound (the held experts' weights read once
     at 3.35 TB/s; the routed rows' FLOPs at 989 TFLOP/s) and beside
     ``grouped_pays``'s choice;
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
     set) and the tokens each prefill drops, and every attention kernel
     call held against its plain version on the same inputs; first a
     witness on the phase's prompt and on prompts from seeds 1-8: decode
     step 0's error free and with every path's routing pinned to the
     float32 path's experts, where the kernel path must hold the rule;
 19. granite serve: ``serve.main --arch granite-moe-1b-a400m`` with phase
     5's traffic; fails unless all 16 complete, flash ran exactly 24 times
     per prefill and paged decode exactly 24 times per decode step and
     per engine's warm-up step (both at head dim 64), neither dense decode
     nor WKV ran, and each handoff carried 24 MiB;
 20. granite profile: phase 11 for granite's engine, with the MoE FFN's
     device time, share and launches per step;
 21. hymba model: full-width, full-depth hymba-1.5b (32 layers, 25/5 heads
     of 64, a sliding window of 1024 beside a selective SSM of state 16),
     bf16, random weights from seed 0: a prefill of 1,100 tokens (past the
     window: banded flash, the ring rolled) and 8 dense decode steps (the
     ring wrapped), three ways by phase 4's rule; layer 0's ring K/V and
     convolution state must be bit-identical between the kernel and plain
     paths and its SSM state within SCAN_RTOL (the kernel path's prompt
     scan is the selective-scan kernel), and every flash and dense decode
     call, in all layers, agree with its plain version on the same inputs; the plain bf16 path's distance
     from float32 is printed at 2, 4, 8 and 16 layers too, and at 2 and 4
     on the host's CPU from the same weights and prompt;
 22. hymba serve: ``serve.main --arch hymba-1.5b`` with phase 5's traffic;
     fails unless all 16 complete, flash and the selective scan ran
     exactly 32 times per prefill and dense decode exactly 32 times per
     decode step and per engine's warm-up step, neither paged decode nor
     WKV ran, and each handoff
     carried the ring and the SSM state, 45,527,040 bytes;
 23. hymba profile: phase 11 for hymba's engine, with the SSM branch's
     device time, share and launches per step (``ssm`` spans around
     ``ssm_apply`` and ``ssm_step``);
 24. musicgen model: full-width, full-depth musicgen-large (48 layers,
     32/32 heads of 64: G = 1, vocabulary 2048), bf16, random weights
     from seed 0, checked as phase 4 (a prefill of 512 and 4 paged decode
     steps, three ways, the same rule), every flash and paged decode call
     held against its plain version on the same inputs; peak memory;
 25. musicgen serve: ``serve.main --arch musicgen-large`` with phase 5's
     traffic; fails unless all 16 complete, flash ran exactly 48 times
     per prefill and paged decode exactly 48 times per decode step and
     per engine's warm-up step, neither dense decode nor WKV ran, and
     each handoff carried 201,326,592 bytes;
 26. kv-quant model: full-width qwen2.5-3b with ``kv_quant=True`` (an int8
     dense cache with a bf16 scale per token and KV head), a prefill of 4
     prompts of 512 and 4 dense decode steps, kernel and plain kv-quant
     bf16 against the unquantized float32 model by phase 4's rule; layer
     0's int8 K/V and scales bit-identical between the two bf16 paths;
     every flash and dense decode call held against its plain version;
 27. kv-quant serve: phase 8's dense serve on the kv-quant configuration;
     fails unless all 4 complete, dense decode ran exactly once per layer
     per decode step and warm-up step, flash once per layer per prefill,
     paged decode never, and each handoff is exactly 130/256 of phase 8's;
     then phase 11's profile of a kv-quant dense engine, with the
     dequantization's device time per step;
 28. speculative: qwen2.5-3b as target, its first 4 blocks as the draft,
     a 512-token prompt, 64 tokens, k = 4: on the plain float32 path the
     tokens (of that draft, and of a self-draft, which must accept every
     proposal) equal the target's greedy decode; on the kernel bf16 path,
     counted, flash ran exactly 36 x target calls + 4 x draft prefills
     and dense decode 4 x draft steps, and the first token that differs
     from the bf16 greedy decode, if any, is a near-tie there; prints
     acceptance, target calls and tokens/s beside the greedy decode's;
 29. llava model: full-width, full-depth llava-next-34b (60 layers, 56/8
     heads of 128: G = 7; 64.2 GiB of bf16 weights), random weights from
     seed 0, a vision prompt from ``synth_inputs`` (2,880 patch
     embeddings projected by the 2-layer MLP and prepended to 512 text
     tokens: 3,392 positions), ``prefill_full`` and 4 paged decode steps,
     three ways by phase 4's rule, every flash and paged decode call held
     against its plain version on the same inputs; peak memory; every
     tensor freed before phase 30;
 30. llava serve: ``serve.main --arch llava-next-34b`` with phase 5's
     traffic (text prompts, as the reference's engine feeds); fails unless
     all 16 complete, flash ran exactly 60 times per prefill and paged
     decode exactly 60 times per decode step and per engine's warm-up
     step, neither dense decode nor WKV ran, and each handoff carried
     125,829,120 bytes;
 31. training at full width, with no kernel launch allowed (none has a
     backward): qwen2.5-3b at full depth through the ``Trainer`` (AdamW,
     remat, 5 steps of 4 x 512: loss, grad norm, step seconds, tokens/s,
     peak memory, the step's bound); at 4 layers, step 0's bf16 loss and
     grads against a float32 upcast by ``TRAIN_RULE``, then 12 AdamW
     steps at lr 1e-3 that must lower the loss; granite-moe-1b-a400m,
     rwkv6-1.6b and hymba-1.5b at 4 layers, 2 steps each, finite;
 32. the training launcher on the card: a smoke-size trainer crashed at
     step 6 (``fail_at``), ``launch.train.main --device cuda`` resuming it
     from its step-4 checkpoint to step 10, a fresh launcher run to 10;
     the resumed parameters within 2e-5 of the fresh ones, bit-equality
     printed.
 33. the dry run on the host: ``python -m repro_torch.launch.dryrun`` for
     one serve cell per family on the 16x16 mesh (a fake process group of
     512 ranks, no card): qwen2.5-3b decode_32k, granite-moe-1b-a400m
     prefill_32k, rwkv6-1.6b long_500k, hymba-1.5b decode_32k,
     kimi-k2-1t-a32b decode_32k (``--variant etp``) and mistral-large-123b
     decode_32k, one process each, all at once; fails unless each is ``ok``
     with the JAX package's per-device argument bytes
     (``DRYRUN_ARG_BYTES``); prints each one's per-device peak and
     collective counts;
 34. the dry run against the card: qwen2.5-3b at full width and depth,
     random bf16 weights from seed 0, a prefill of 2 x 4,096 and a dense
     decode step of 16 slots over 8,192 (4,096 cached): the dry run's
     prediction on a fake 1x1 mesh (a child process), then the step it
     traced (``impl="xla"``, the reference's lowering) on the card, the
     plain path's peak beside it; fails unless the argument bytes equal
     those on the card exactly and the predicted peak is at least 0.9 of
     the measured one (the ratio printed); then the kernel path, counted
     (flash exactly 36 launches for the prefill, dense decode exactly 36
     for the step, nothing else), held by phase 4's rule against a
     float32 upcast, its peak printed, and run again under
     ``AttentionTap`` (each kernel call against its plain version);
     last, the plain prefill on a one-rank NCCL mesh
     (``make_host_mesh``, DTensor parameters), whose logits must be
     bit-equal to the plain prefill's without a mesh;
 35. the static analysis on the host: ``python -m repro_torch.analysis
     --json`` over this checkout in a child process (no card, no jax);
     fails unless it is ``ok``, checked one module per ``.py`` file under
     ``src/`` and ``tests/``, and baselined as many findings as
     ``baseline.json`` budgets, and unless a child process's import of
     ``repro_torch.analysis.__main__`` and
     ``repro_torch.serving.speculative`` leaves torch unloaded; prints
     each pass's host milliseconds beside the card's name and power
     limit. It launches no kernel.

Phase 3 also holds flash, paged and dense decode at head dim 64 (granite's
16/8 heads) against their plain versions at the serve's shapes and their
edges, and times each beside its bound and SDPA's device time; phase 3g
does so for flash at hymba's 25/5 heads (G = 5, dh 64) without and with
its window of 1024 (S = 512 as the serve calls it, which the wrapper
launches unbanded, and with the widest window that bands; 1100, 2048, a
ragged B = 2 case at an offset; a window of at least Sq + q_offset
bit-identical to none; SDPA given the band as an explicit mask) and for
dense decode over the 1024-row ring (lengths 1 to 1024, poisoned rows);
phase 3h does so for flash and paged decode at musicgen-large's 32/32
heads of 64 (G = 1) and for flash at the verify pass's shape (4 query
rows after 512 cached ones); phase 3i for flash and paged decode at
llava-next-34b's 56/8 heads of 128 (G = 7), flash timed at the text
prompt's S = 512 and the vision prompt's S = 3,392. Phase 18 also
relaunches layer 0's MoE FFN 20 times (bit-equal outputs, or it fails),
beside the reference's scatter-add combine (``index_add_``) relaunched
as often, and fails unless each bf16 path run twice gives bit-equal
logits.

Every path (5-8, 10, 12-14, 16, 19, 22, 25, 27, 28, 30-32, 34) runs with
every kernel's launch count and the MoE's grouped calls
(``moe.grouped_calls``) set to 0 just before it and read just after; no
path prefills a long MoE prompt, so each must count no grouped call. Each
phase prints its seconds.

The last three lines of standard output are the card's name and power
limit, the ``{"kernels": [...]}`` record and ``{"ok": true, "device":
...}``. Without a card, or without the repository beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
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
# the selective-scan kernel and its plain chunked version both compute in
# fp32 from the same inputs and differ only in how they compose positions
# (a scan of 16-position segments against 256-position doubling chunks):
# relative to each output row's norm
SCAN_RTOL = 1e-4
SCAN_STATE = 16                         # the SSM state size of both models
# the MoE FFN's grouped dispatch against the padded one: both round h, u
# and the expert output to bf16 at the same points and differ only in
# the products' accumulation order, so a value may differ by one bf16
# unit (2^-8) in any of them: two units of the output's scale
MOE_RTOL = 2 ** -7
# the jamba and granite cells' MoE layers: d_model, expert width, held
# experts, the router's experts, top-k
JAMBA_MOE = (4096, 14336, 8, 16, 2)
GRANITE_MOE = (1024, 512, 32, 32, 8)
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
# hymba-1.5b's (query, KV) heads of dh 64 (G = 5) and its sliding window:
# the KV ring of its dense decode cache is as many rows
HYMBA = "hymba-1.5b"
HEADS_HYMBA = (25, 5)
HYMBA_WINDOW = 1024
# musicgen-large's (query, KV) heads of dh 64: multi-head attention, G = 1,
# the attention kernels' emptiest packing
MUSICGEN = "musicgen-large"
HEADS_MUSICGEN = (32, 32)
# speculative decoding's draft depth (the target's first blocks) and
# proposals per verify pass; a bf16 near-tie, relative to max(1, scale)
DRAFT_LAYERS = 4
SPEC_K = 4
NEAR_TIE = 2e-2
# llava-next-34b's (query, KV) heads of dh 128 (G = 7: 9 positions in a
# flash tile's 64 rows, one row dead), its vision prompt (2,880 patch
# embeddings before 512 text tokens) and one 512-token prompt's handoff
LLAVA = "llava-next-34b"
HEADS_LLAVA = (56, 8)
LLAVA_TEXT = 512
LLAVA_HANDOFF = 125_829_120
# phase 31's rule for a bf16 train step against the float32 one on the
# same weights and batch: bf16 keeps 8 bits of mantissa (2^-9 relative per
# rounding); over 4 layers' forward and backward at full width the grads
# sit ~2-3% (relative L2) from float32 and the loss ~1e-4 relative (the
# same step on the host's CPU, vocabulary cut to 16,384): the rule allows
# about three times that — loss, all grads together, each grad leaf
TRAIN_RULE = {"loss": 1e-3, "grads": 6e-2, "leaf": 0.1}
# phase 31's descent: 12 AdamW steps, warmup 2, on batches 0 and 1 in
# turn, as the reference's test_optimizer_decreases_loss, whose lr of
# 1e-2 suits its 64-wide model: at qwen2.5-3b's width it raises the JAX
# package's own loss over the 12 steps (10.25 -> 13.98, float32 on the
# host's CPU, 4 layers, vocabulary cut to 16,384), where 1e-3 lowers it
# (10.25 -> 0.09)
DESCEND_LR = 1e-3
# phase 32's hold of resumed against fresh parameters: the reference's
# own test_trainer_crash_resume_exact bound
RESUME_ATOL = 2e-5
# phase 17's design grid, its content address and the perf-model points it
# evaluates (both deterministic: the JAX package's sweep gives the same)
SWEEP_ARGS = ["--models", "llama-3.1-8b", "qwen3-14b", "phi3-medium-14b",
              "qwen2.5-3b", "rwkv6-1.6b", "--hardware", "h100", "a100",
              "h100:a100", "--isl", "512", "2048", "8192", "--osl", "64",
              "256", "--reuse", "0.0", "0.5", "--modes", "disagg", "coloc",
              "--max-chips", "64", "--simulate", "--workers", "4", "--quiet"]
SWEEP_HASH, SWEEP_POINTS, SWEEP_CELLS = "4944b71631008786", 695_418, 240
# phase 33's dry-run cells on the 16x16 mesh, one serve cell per family,
# and each one's per-device argument bytes (params, cache, inputs): the JAX
# package's own ``build_cell`` gives these (tests/test_torch_dryrun.py
# derives them there)
DRYRUN_ARG_BYTES = {
    ("qwen2.5-3b", "decode_32k", "base"): 1_099_712_032,
    ("granite-moe-1b-a400m", "prefill_32k", "base"): 223_713_280,
    ("rwkv6-1.6b", "long_500k", "base"): 212_176_904,
    ("hymba-1.5b", "decode_32k", "base"): 456_981_664,
    ("kimi-k2-1t-a32b", "decode_32k", "etp"): 16_142_232_096,
    ("mistral-large-123b", "decode_32k", "base"): 7_127_327_264,
}


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
    head dim (``flash_fwd_kernel<64>``), the flash kernel's window
    (``flash_fwd_kernel<64, window>``), the selective scan's state size
    and delta (``selective_scan_kernel<16, shared delta>``)."""
    m = line.split("'")[1]
    i, name = (3 if m.startswith("_ZN") else 2), m
    while i < len(m) and m[i].isdigit():
        j = i
        while m[j].isdigit():
            j += 1
        n = int(m[i:j])
        name, i = m[j:j + n], j + n
    targs = re.match(r"ILi(\d+)E(?:Lb([01])E)?(f|13__nv_bfloat16)?E",
                     m[i:])
    if targs and targs.group(3):
        name += f"<{targs.group(1)}, " + (
            "fp32" if targs.group(3) == "f" else "bf16") + ">"
    elif targs and targs.group(2):
        flag = (("shared delta", "delta per channel")
                if name.startswith("selective_scan") else
                ("window", "no window"))
        name += f"<{targs.group(1)}, " + (
            flag[0] if targs.group(2) == "1" else flag[1]) + ">"
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


def flash_work(B, Sq, Skv, H, Hkv, q_offset, dh=128, window=0):
    """The least work of causal (banded, with ``window``) attention: the
    (row, key) pairs it must score, each key row read once."""
    pairs = sum(min(Skv, q_offset + i + 1)
                - (max(0, q_offset + i + 1 - window) if window else 0)
                for i in range(Sq))
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


def row_err(out, ref) -> float:
    """The largest error relative to its row's norm, rows along the last
    dim."""
    diff = (out.double() - ref.double()).norm(dim=-1)
    return (diff / ref.double().norm(dim=-1).clamp_min(1e-30)).max().item()


def scan_case(torch, gen, B, S, di, dev, shared=False):
    """fp32 inputs as a mixer passes them: delta = softplus of a dt around
    Mamba's init (~0.1), per channel or one shared [B,S]; A = -(1..16) per
    channel, perturbed; B and C of unit scale (RMS-normed); a nonzero
    state."""
    def f(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    ds = SCAN_STATE
    delta = torch.nn.functional.softplus(
        (f(B, S) if shared else f(B, S, di)) - 2.5)
    A = -torch.exp(torch.log(torch.arange(1, ds + 1, device=dev).float()
                             )[None] + 0.1 * f(di, ds))
    return f(B, S, di), f(B, S, ds), f(B, S, ds), delta, A, 0.5 * f(B, di, ds)


def scan_work(B, S, di, shared=False):
    """The recurrence's least work: 9 fp32 operations a state update (the
    benchmark's SCAN_FLOPS: delta A, its exp, delta x, its product with B,
    the update and C h); x, delta (one per channel or one shared), B and C
    read once, A and the state read once, y and the last state written
    once."""
    ds = SCAN_STATE
    flops = 9.0 * B * S * di * ds
    nbytes = 4.0 * (B * S * di * (2 if shared else 3)
                    + B * S * (2 * ds + (1 if shared else 0))
                    + di * ds + 2 * B * di * ds)
    return flops, nbytes


def scan_phase(torch, dev, gen, timer):
    """The selective-scan kernel at Jamba's prefill shapes (di 8,192, a
    delta per channel, S 1,024 and 2,048) and hymba's (di 1,600, one
    shared delta, S 512), from a nonzero state, against its plain chunked
    version within SCAN_RTOL of each row's norm; then timed at each beside
    the plain version and the bound. Returns (the largest row error, the
    Jamba S = 1,024 timings with the others under their shapes)."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.models.ssm import _scan
    shapes = {"jamba_1024": (1, 1024, 8192, False),
              "jamba_2048": (1, 2048, 8192, False),
              "hymba_512": (1, 512, 1600, True)}
    err_max = 0.0
    for name, (B, S, di, shared) in shapes.items():
        case = scan_case(torch, gen, B, S, di, dev, shared)
        y, h = scan_ops.selective_scan(*case)
        torch.cuda.synchronize()
        y_p, h_p = _scan(*case)
        err = max(row_err(y, y_p), row_err(h, h_p))
        log(f"# scan {name} B={B} S={S} di={di} shared delta {shared}: "
            f"row error against the plain scan {err:.3e}")
        if not (math.isfinite(err) and bool(torch.isfinite(y).all())
                and err <= SCAN_RTOL):
            fail(f"selective scan {name} disagrees with its plain version: "
                 f"{err}")
        err_max = max(err_max, err)

    def time_scan(name):
        B, S, di, shared = shapes[name]
        flops, nbytes = scan_work(B, S, di, shared)
        cases = [scan_case(torch, gen, B, S, di, dev, shared)
                 for _ in range(copies(nbytes))]
        res = {"ms": timer(scan_ops.selective_scan, cases),
               "device_ms": timer.device(scan_ops.selective_scan, cases),
               "plain_ms": timer(_scan, cases, runs=3),
               "library_ms": None}  # no PyTorch call computes the scan
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes,
                                                 PEAK_FP32_FLOPS)
        log(f"# scan time {name} B={B} S={S} di={di} ({len(cases)} input "
            "sets): " + json.dumps(res))
        return res

    row = time_scan("jamba_1024")
    row["jamba_2048"] = time_scan("jamba_2048")
    row["hymba_512"] = time_scan("hymba_512")
    return err_max, row


def moe_phase(torch, dev, gen, timer):
    """The MoE FFN alone, one layer in bf16 at the port's initialiser's
    scales: at the jamba cell's shapes (``JAMBA_MOE``) for prompts of 256
    to 2,048 tokens, and at the granite cell's (``GRANITE_MOE``) for
    prompts of 2,048 to 32,768, on both sides of ``grouped_pays``'s line.
    At each: the grouped dispatch against the padded one within MOE_RTOL
    of the output's scale, the same drops, a relaunch bit-equal; each
    timed by CUDA events beside the bound: the held experts' weights read
    once, and the routed rows' three products (2 x 3 x N x D x F FLOPs, N
    the pairs routed to a held expert); the rule's choice beside the
    faster way. The rule must take the grouped way for the jamba cell's
    prompts (512 to 2,048 tokens). Returns {(model, tokens): timings}."""
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig
    out = {}
    for model, (D, F_, E, routed, k), lengths in (
            ("jamba", JAMBA_MOE, (256, 448, 512, 1024, 2048)),
            ("granite", GRANITE_MOE, (2048, 4096, 16384, 32768))):
        # jamba's gates are not renormalised over the held half
        cfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=F_,
                        capacity_factor=routed / k, router_experts=routed,
                        renormalize=model == "granite")

        def draw(shape, scale, dtype=torch.bfloat16):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    ).to(dtype)
        w = (draw((D, routed), 0.02, torch.float32),
             draw((E, D, F_), D ** -0.5), draw((E, D, F_), D ** -0.5),
             draw((E, F_, D), F_ ** -0.5))
        padded = functools.partial(moe._local_moe, cfg=cfg)
        grouped = functools.partial(moe._local_moe, cfg=cfg, grouped=True)
        with torch.inference_mode():
            for T in lengths:
                x = draw((T, D), 1.0)
                pays = moe.grouped_pays(x, cfg)
                if model == "jamba" and T >= 512 and not pays:
                    fail(f"moe: a {T}-token jamba prompt would stay padded")
                want, want_aux = padded(x, *w)
                got, got_aux = grouped(x, *w)
                again = grouped(x, *w)[0]
                torch.cuda.synchronize()
                scale = max(want.abs().max().item(), 1.0)
                err = (got - want).abs().max().item() / scale
                same = torch.equal(got, again)
                drops = (got_aux["moe_dropped"].item(),
                         want_aux["moe_dropped"].item())
                if not (err <= MOE_RTOL and same and drops[0] == drops[1]):
                    fail(f"moe {model} T={T}: grouped against padded "
                         f"{err:.3e} of the scale, relaunch equal {same}, "
                         f"dropped {drops}")
                mask = moe._route(x, w[0], cfg)[1]
                N = int(mask[:, :E].sum().item())
                flops = 2.0 * 3 * N * D * F_
                nbytes = 3.0 * E * D * F_ * 2
                res = {"padded_ms": timer(padded, [(x, *w)]),
                       "grouped_ms": timer(grouped, [(x, *w)]),
                       "routed_rows": N,
                       "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                       "flops_ms": flops / PEAK_BF16_FLOPS * 1e3,
                       "max_err_of_scale": err,
                       "rule": "grouped" if pays else "padded"}
                res["faster"] = ("grouped" if res["grouped_ms"]
                                 < res["padded_ms"] else "padded")
                res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
                log(f"# moe time {model} T={T}: " + json.dumps(res))
                out[model, T] = res
                del x, want, got, again
        del w
        gc.collect()
        torch.cuda.empty_cache()
    return out


def hymba_kernels(torch, dev, gen, fl_ops, dec_ops, flash_ref,
                  dense_ref) -> dict:
    """Phase 3g's checks at hymba-1.5b's heads (25/5 of 64, G = 5): flash
    at the serve's prefill (S = 512 with the window of 1024, which the
    wrapper launches unbanded), at 512 with the widest window that bands
    (511), at S = 1100 and 2048 with the window of 1024 and a ragged B = 2
    case at an offset, each against its plain version; a window of at
    least Sq + q_offset bit-identical to none; dense decode over the
    1024-row ring at lengths min(pos + 1, 1024) from one token to a
    wrapped ring, against its plain version and with the rows at or past
    each length poisoned. Returns the largest error of each kernel."""
    H, Hkv = HEADS_HYMBA
    W = HYMBA_WINDOW
    errs = {"flash": 0.0, "dense": 0.0}
    for (B, Sq, Skv, off, window) in [(1, 512, 512, 0, W),
                                      (1, 512, 512, 0, 511),
                                      (1, 1100, 1100, 0, W),
                                      (1, 2048, 2048, 0, W),
                                      (2, 1500, 1577, 77, W),
                                      (2, 97, 260, 163, 37)]:
        q, k, v = flash_case(torch, gen, B, Sq, Skv, H, Hkv, dev, 64)
        out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off,
                                     window=window)
        torch.cuda.synchronize()
        ref = flash_ref(q, k, v, causal=True, q_offset=off, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"# flash hymba H={H} Hkv={Hkv} B={B} Sq={Sq} Skv={Skv} "
            f"off={off} window={window}: max_abs_err {err:.3e}")
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"flash at hymba's heads (window {window}) disagrees: {err}")
        errs["flash"] = max(errs["flash"], err)
        if window:
            wide = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off,
                                          window=Sq + off)
            full = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
            torch.cuda.synchronize()
            if not torch.equal(wide, full):
                fail(f"flash: a window of Sq + q_offset = {Sq + off} differs "
                     "from no window")
    log("# flash hymba: a window of Sq + q_offset is bit-identical to none")
    lengths = [1, 37, 544, W, W, W - 1, 512, 2]
    q, kc, vc, lens = dense_case(torch, gen, lengths, W, H, Hkv, dev, 64)
    out = dec_ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = (out.float() - dense_ref(q, kc, vc, lens).float()).abs().max().item()
    kc2, vc2 = kc.clone(), vc.clone()
    for b, n in enumerate(lengths):
        kc2[b, n:], vc2[b, n:] = 1e4, -1e4
    same = torch.equal(out, dec_ops.decode_attention(q, kc2, vc2, lens))
    log(f"# dense hymba ring H={H} Hkv={Hkv} Smax={W} lengths={lengths}: "
        f"max_abs_err {err:.3e}, poisoned rows "
        f"{'bit-unchanged' if same else 'LEAKED'}")
    if not math.isfinite(err) or err > KERNEL_ATOL or not same:
        fail(f"dense decode over hymba's ring disagrees ({err}) or leaks")
    errs["dense"] = err
    return errs


def attention_at_heads(torch, dev, gen, fl_ops, dec_ops, flash_ref, heads,
                       dh, flash_shapes, paged_cases, what) -> dict:
    """Flash at ``flash_shapes`` ((B, Sq, Skv, q_offset) each) and paged
    decode at ``paged_cases`` ((lengths, table width or None) each), for
    ``heads`` (query, KV) of ``dh``, against their plain versions; the
    paged kernel also with the trash block and every tail past a length
    poisoned, which must leave its output bit-unchanged. Phase 3e
    (granite's heads) and 3h (musicgen's). Returns the largest error of
    each kernel."""
    H, Hkv = heads
    errs = {"flash": 0.0, "paged": 0.0}
    for (B, Sq, Skv, off) in flash_shapes:
        q, k, v = flash_case(torch, gen, B, Sq, Skv, H, Hkv, dev, dh)
        out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        err = (out.float() - flash_ref(q, k, v, causal=True, q_offset=off)
               .float()).abs().max().item()
        log(f"# flash {what} H={H} Hkv={Hkv} B={B} Sq={Sq} Skv={Skv} "
            f"off={off}: max_abs_err {err:.3e}")
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"flash at {what} disagrees: {err}")
        errs["flash"] = max(errs["flash"], err)
    for lens_g, nb in paged_cases:
        q, pk, pv, tbl, lens = paged_case(torch, gen, lens_g, 8, H, Hkv, dev,
                                          nb, dh)
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
        log(f"# paged {what} H={H} Hkv={Hkv} lengths={lens_g} nb="
            f"{tbl.shape[1]}: max_abs_err {err:.3e}, poisoned blocks "
            f"{'bit-unchanged' if same else 'LEAKED'}")
        if not math.isfinite(err) or err > KERNEL_ATOL or not same:
            fail(f"paged decode at {what} disagrees ({err}) or leaks "
                 f"({same})")
        errs["paged"] = max(errs["paged"], err)
    return errs


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


def tree_to(tree, device):
    """A copy of nested dicts and lists of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


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
    the last ``take``: (masks in call order, drops summed). ``pin(masks)``
    makes the next calls, in order, route to those masks' expert sets
    (each token's gates its own probabilities over the pinned set,
    renormalised, as ``_route`` renormalises its top-k); ``pin(None)``
    frees the routing again."""

    def __init__(self):
        import torch
        from repro_torch.models import moe
        self.torch, self.moe, self.calls, self.pinned = torch, moe, [], None

    def pin(self, masks):
        self.pinned = None if masks is None else list(masks)

    def __enter__(self):
        route, local = self.orig = (self.moe._route, self.moe._local_moe)

        def tap_route(x, router_w, cfg):
            out = route(x, router_w, cfg)
            if self.pinned is not None:
                mask = self.pinned.pop(0)
                probs = self.torch.softmax(x.float() @ router_w.float(), -1)
                gates = probs * mask
                out = (gates / gates.sum(-1, keepdim=True), mask) + out[2:]
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


class AttentionTap:
    """While on, holds every attention kernel call of the model against
    its plain version on the same inputs: the transformer module's
    ``flash_attention``, ``decode_attention`` and
    ``decode_attention_paged`` are wrapped for the model check only (no
    serve runs under it, and no path's launches are counted then). The
    error is relative to max(1, the plain output's largest magnitude):
    phase 3's inputs are of unit scale, a model layer's need not be.
    Each call is launched twice, and the calls whose two outputs are not
    bit-identical are counted. ``check(what)`` logs each kernel's calls,
    largest error and such calls since the last check and fails on an
    error above ``KERNEL_ATOL``."""

    def __init__(self):
        import torch
        from repro_torch.kernels.decode_attention import ops as dec_ops
        from repro_torch.kernels.decode_attention.ref import \
            decode_attention_ref
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref
        from repro_torch.models import transformer
        self.T, self.torch = transformer, torch
        self.plain = {"flash_attention": flash_attention_ref,
                      "decode_attention": decode_attention_ref,
                      "decode_attention_paged":
                          dec_ops.decode_attention_paged_plain}
        self.seen = {}

    def __enter__(self):
        self.orig = {name: getattr(self.T, name) for name in self.plain}
        torch = self.torch

        def tapped(name, kernel, plain):
            def call(*args, **kw):
                out = kernel(*args, **kw)
                differs = not torch.equal(out, kernel(*args, **kw))
                ref = plain(*args, **kw).float()
                err = ((out.float() - ref).abs().max()
                       / ref.abs().max().clamp(min=1.0)).item()
                n, worst, nd = self.seen.get(name, (0, 0.0, 0))
                self.seen[name] = (n + 1, max(worst, err)
                                   if math.isfinite(err) else math.inf,
                                   nd + differs)
                return out
            return call

        for name, kernel in self.orig.items():
            setattr(self.T, name, tapped(name, kernel, self.plain[name]))
        return self

    def __exit__(self, *exc):
        for name, kernel in self.orig.items():
            setattr(self.T, name, kernel)

    def check(self, what):
        seen, self.seen = self.seen, {}
        log(f"# {what}: attention kernels against their plain versions on "
            "the same inputs (calls, largest error / max(1, scale), calls "
            "whose relaunch differs): " + ", ".join(
                f"{k} {n} {e:.3e} {nd}" for k, (n, e, nd) in seen.items()))
        bad = {k: e for k, (n, e, _) in seen.items() if not e <= KERNEL_ATOL}
        if not seen or bad:
            fail(f"{what}: attention kernels off their plain versions on "
                 f"the model's own inputs: {bad or 'no call tapped'}")


def paged_slots(torch, T, cfgs, caches, S: int, dev, slots: int = 4):
    """Block pools of 8-token blocks (one per configuration and its
    S-token prefill cache) and the shared tables of ``slots`` decode slots
    that all hold that cache, with 8 blocks each to grow into. Returns
    (pools, tables, pos)."""
    cfg, extra, Bs = cfgs[0], 8, 8
    Lr, nbk = cfg.num_layers, S // Bs
    width = 1
    while width < nbk + extra:
        width *= 2
    n_blocks = 1 + Lr * slots * (nbk + extra)
    pools = [T.init_block_pool(c, n_blocks, Bs, device=dev) for c in cfgs]
    tables = torch.zeros((Lr, slots, width), dtype=torch.int32, device=dev)
    for s in range(slots):
        first = 1 + s * Lr * (nbk + extra)
        ids = torch.arange(first, first + Lr * (nbk + extra), device=dev,
                           dtype=torch.int32).reshape(Lr, nbk + extra)
        tables[:, s, :nbk + extra] = ids
        for pool, c in zip(pools, caches):
            T.scatter_blocks(pool, ids[:, :nbk], {
                kk: c[kk][:, 0].reshape(Lr, nbk, Bs, -1, cfg.dh)
                for kk in ("k", "v")})
    return pools, tables, torch.full((slots,), S, dtype=torch.int32,
                                     device=dev)


def model_phase(torch, cfg, dev, gen, S: int = 512, steps: int = 4,
                tap=None, prompt=None, params=None, attn=None):
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
    paths is reported as well, and with ``attn`` (an ``AttentionTap``
    that is on) each step's kernel calls are held against their plain
    versions. ``prompt`` is drawn from ``gen`` and ``params`` from seed 0
    unless given."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params
    if params is None:
        params = init_torch_params(cfg, 0, device=dev)
    p32 = upcast(params)
    c32 = cfg.replace(dtype="float32")
    if prompt is None:
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
        if attn is not None:
            attn.check(f"model {cfg.name} {what}")

    with torch.inference_mode():
        lk, cache = run(T.prefill_full, params, cfg, {"tokens": prompt},
                        impl="kernel")
        lp, _ = run(T.prefill_full, params, cfg, {"tokens": prompt},
                    impl="plain")
        lr, cache32 = run(T.prefill_full, p32, c32, {"tokens": prompt},
                          impl="plain")
        check(f"prefill S={S}", lk, lp, lr)
        pools, tables, pos = paged_slots(torch, T, (cfg, cfg, c32),
                                         (cache, cache, cache32), S, dev)
        toks = torch.full((pos.shape[0],), int(lr.argmax()), device=dev)
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


def hymba_model_phase(torch, cfg, dev, gen, S: int = 1100, steps: int = 8):
    """Phase 21: hymba-1.5b at full width and depth, random weights from
    seed 0: a prefill of S tokens (past the window, so the banded flash
    kernel runs and the ring is rolled) and dense decode steps from each
    version's own cache (the ring wraps), three ways (kernel bf16, plain
    bf16, plain fp32 upcast one block at a time), held by ``hold``.

    The kernel and plain paths differ only in attention and the prompt's
    scan, and no layer's cache entry depends on its own attention output:
    layer 0's ring K/V and convolution state must be equal bit for bit
    between them after the prefill and after each decode step, which
    checks the ring placement and the in-place writes of the kernel path,
    and its SSM state within SCAN_RTOL of each row's norm (the kernel
    path's prefill scans with the selective-scan kernel, the plain path
    with ``_scan``; both decode steps are the same plain step). Every flash and dense
    decode call of the kernel path, in all layers, is held against its
    plain version on the same inputs (``AttentionTap``): bf16 sits far
    from fp32 on random hymba weights, so ``hold`` alone says little. The
    plain bf16 path's distance from fp32 after the prefill is logged at
    cut depths too (the first 2, 4, 8 and 16 layers), and at 2 and 4
    layers on the host's CPU from the same weights and prompt, to set
    beside the CPU tests' figures for the JAX package. Returns the bf16
    weights."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params
    params = init_torch_params(cfg, 0, device=dev)
    runs = [(params, cfg, "kernel"), (params, cfg, "plain"),
            (upcast(params), cfg.replace(dtype="float32"), "plain")]
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device=dev)

    def same_layer0(what, ck, cp):
        same = {key: torch.equal(ck[key][0], cp[key][0])
                for key in ("k", "v", "conv")}
        same["ssm_h"] = row_err(ck["ssm_h"][0], cp["ssm_h"][0]) <= SCAN_RTOL
        if not all(same.values()):
            fail(f"{cfg.name} {what}: layer 0's cache differs between the "
                 f"kernel and the plain path: {same}")

    with torch.inference_mode(), AttentionTap() as attn:
        out = [T.prefill_full(p, c, {"tokens": prompt}, impl=impl)
               for p, c, impl in runs]
        hold(torch, f"{cfg.name} prefill S={S} (window "
             f"{cfg.sliding_window})", cfg.num_layers,
             *(lg for lg, _ in out), cfg.vocab_size)
        attn.check(f"model {cfg.name} prefill S={S}")
        caches = [cache for _, cache in out]
        if caches[0]["k"].shape[2] != cfg.sliding_window:
            fail(f"{cfg.name}: ring of {caches[0]['k'].shape[2]} rows")
        same_layer0(f"prefill S={S}", caches[0], caches[1])
        toks = out[2][0][:, :cfg.vocab_size].argmax(-1)
        for step in range(steps):
            logits = []
            for (p, c, impl), cache in zip(runs, caches):
                lg, _ = T.decode_step(p, c, cache, toks, impl=impl)
                logits.append(lg)
            same_layer0(f"decode step {step}", caches[0], caches[1])
            hold(torch, f"{cfg.name} decode step {step} (pos {S + step}, "
                 f"ring slot {(S + step) % cfg.sliding_window})",
                 cfg.num_layers, *logits, cfg.vocab_size)
            attn.check(f"model {cfg.name} decode step {step}")
            toks = logits[2][:, :cfg.vocab_size].argmax(-1)
        del caches, out

        def drift_at(n, device):
            cut = tree_to({**params, "blocks": params["blocks"][:n]},
                          device)
            c, tokens = cfg.replace(num_layers=n), {"tokens":
                                                    prompt.to(device)}
            lp, _ = T.prefill_full(cut, c, tokens, impl="plain")
            lr, _ = T.prefill_full(upcast(cut), c.replace(dtype="float32"),
                                   tokens, impl="plain")
            lp, lr = (t[..., :cfg.vocab_size].float() for t in (lp, lr))
            return ((lp - lr).abs().max() / lr.abs().max()).item()

        drift = {n: drift_at(n, dev) for n in (2, 4, 8, 16)}
        host = {n: drift_at(n, "cpu") for n in (2, 4)}
    log(f"# model {cfg.name}: layer 0's ring K/V and conv bit-identical "
        "between the kernel and plain paths at every step, ssm_h within "
        f"{SCAN_RTOL} of each row's norm")
    log(f"# model {cfg.name} prefill S={S}: plain bf16 vs fp32 / scale at "
        "the first n layers: " + ", ".join(f"{n}: {d:.3e}"
                                          for n, d in drift.items())
        + "; the same weights and prompt on the host's CPU: " + ", ".join(
            f"{n}: {d:.3e}" for n, d in host.items()))
    del runs
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
    ``moe_ffn`` call under a ``record_function`` span, for a hybrid model
    every ``ssm_apply`` / ``ssm_step`` call under an ``ssm`` span, for a
    kv-quant model every ``_kv_dequant`` call under a ``kv_dequant`` span,
    and the kernels launched inside those spans give the MoE FFN's (the SSM
    branch's, the dequantization's) device time, its share of the step's
    and its launches per step. Reports "not measured" rather than failing
    if the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.hardware import get_chip
    from repro_torch.models import moe, ssm
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params, make_engine
    params = init_torch_params(cfg, 0, device=dev)
    layout = {} if paged is None else {"paged": paged}
    eng = make_engine("torch", 0, cfg, params, slots=slots,
                      capacity=S + 64 + 8, chip=get_chip("h100"), device=dev,
                      **layout)
    name = cfg.name + (" kv-quant" if cfg.kv_quant else "") + (
        " dense" if paged is False else "")
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=gen).numpy()
               for _ in range(slots + 4)]

    class Req:
        slot = engine_id = None

    # the spans: name -> the module functions run under it
    spans = ({"moe_ffn": (moe, ("moe_ffn",))} if cfg.moe is not None else
             {"ssm": (ssm, ("ssm_apply", "ssm_step"))}
             if cfg.block == "hybrid" else
             {"kv_dequant": (T, ("_kv_dequant",))} if cfg.kv_quant else {})

    def report(kind, prof, n, wall_s):
        # the device side's kernels, without the GPU-side copies of the
        # spans (an annotation, not a kernel)
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and e.name not in spans]
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
        for span in spans:
            calls = [e for e in prof.events() if e.name == span
                     and e.device_type == DeviceType.CPU]
            ks = [k for e in calls for k in region_kernels(e)]
            if not ks:
                log(f"# profile {kind}: {span} device time not measured (no "
                    f"kernel attributed to the {span} spans)")
                continue
            span_ms = sum(ks) / 1e3 / n
            log(f"# profile {kind}: {span} {len(calls) / n:.0f} calls, "
                f"{len(ks) / n:.0f} kernels and {span_ms:.3f} ms of device "
                f"time per step, {span_ms / busy:.3f} of device busy")

    def spanned(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    def profiled(fn):
        """``fn()`` under the profiler, each call of a span's functions in
        that span."""
        orig = {(mod, f): getattr(mod, f) for mod, fns in spans.values()
                for f in fns}
        for name, (mod, fns) in spans.items():
            for f in fns:
                setattr(mod, f, spanned(name, orig[(mod, f)]))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
        finally:
            for (mod, f), fn_orig in orig.items():
                setattr(mod, f, fn_orig)
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


def routing_witness(torch, cfg, params, dev, prompts, tap, attn) -> None:
    """Phase 18's witness for the model rule at granite's decode step 0.
    For each (name, prompt), the prefill and paged decode step 0 (4 slots,
    as ``model_phase``) run free in float32, kernel bf16 and plain bf16,
    then the two bf16 paths again with their routing pinned to the
    float32 path's expert sets (``RoutingTap.pin``: the same sets, so the
    same capacity drops; each path's own gates). Logs per prompt step 0's
    error of both bf16 paths against float32, free and pinned, and the
    (layer, token) pairs whose top-k set differs between the kernel and
    plain paths and from float32's. Pinned, the bf16 paths differ only in
    rounding and the attention kernels (each call also held against its
    plain version by ``attn``), so the kernel path must hold the rule on
    every prompt; free, the rule is logged only. Each bf16 path also runs
    a second time as it stands, and whether its logits and top-k sets
    come out the same is logged."""
    from repro_torch.models import transformer as T
    p32, c32 = upcast(params), cfg.replace(dtype="float32")
    V, L = cfg.vocab_size, cfg.num_layers

    def run(p, c, impl, prompt, tok=None, pin=None):
        tap.pin(pin)
        lg, cache = T.prefill_full(p, c, {"tokens": prompt}, impl=impl)
        tok = int(lg[:, :V].argmax()) if tok is None else tok
        pools, tables, pos = paged_slots(torch, T, (c,), (cache,),
                                         prompt.shape[1], dev)
        d, _, _ = T.decode_step_paged(
            p, c, pools[0], tables, pos,
            torch.full((pos.shape[0],), tok, device=dev), impl=impl)
        tap.pin(None)
        return d[:, :V].float(), tap.take()[0], tok, lg[:, :V]

    def err(a, ref):
        return ((a - ref).abs().max() / ref.abs().max()).item()

    def flips(ma, mb):
        return sum(int((a != b).any(-1).sum()) for a, b in zip(ma, mb))

    broken = []
    with torch.inference_mode():
        for name, prompt in prompts:
            dr, mr, tok, _ = run(p32, c32, "plain", prompt)
            dk, mk, _, lk = run(params, cfg, "kernel", prompt, tok)
            dp, mp, _, lp = run(params, cfg, "plain", prompt, tok)
            free = err(dk, dr), err(dp, dr)
            # each bf16 path once more, as it stands: it must reproduce its
            # prefill and decode logits bit for bit
            again = [run(params, cfg, impl, prompt, tok)
                     for impl in ("kernel", "plain")]
            same = [torch.equal(d, a[0]) and torch.equal(lg, a[3])
                    for d, lg, a in ((dk, lk, again[0]), (dp, lp, again[1]))]
            dk2, mk2, _, _ = run(params, cfg, "kernel", prompt, tok, mr)
            dp2, mp2, _, _ = run(params, cfg, "plain", prompt, tok, mr)
            pinned = err(dk2, dr), err(dp2, dr)
            if not all(torch.equal(a, b) for m in (mk2, mp2)
                       for a, b in zip(m, mr)):
                fail(f"{cfg.name} witness {name}: pinned routing not taken")
            held = free[0] <= 2 * free[1] + 1e-3
            if not held:
                broken.append(name)
            pre, dec = slice(0, L), slice(L, 2 * L)
            log(f"# witness {cfg.name} {name}: decode step 0 error vs fp32 "
                f"/ scale, free: kernel {free[0]:.3e}, plain bf16 "
                f"{free[1]:.3e} (rule {'held' if held else 'BROKEN'}); "
                f"routing pinned to fp32's experts: kernel {pinned[0]:.3e},"
                f" plain bf16 {pinned[1]:.3e}; top-k sets that differ, "
                f"step 0 (of {sum(m.shape[0] for m in mr[dec])}): kernel "
                f"vs plain {flips(mk[dec], mp[dec])}, kernel vs fp32 "
                f"{flips(mk[dec], mr[dec])}, plain vs fp32 "
                f"{flips(mp[dec], mr[dec])}; prefill (of "
                f"{sum(m.shape[0] for m in mr[pre])}): "
                f"{flips(mk[pre], mp[pre])}, {flips(mk[pre], mr[pre])}, "
                f"{flips(mp[pre], mr[pre])}; run again, the same logits "
                f"and top-k sets that differ (prefill + step 0): kernel "
                f"{same[0]} {flips(mk, again[0][1])}, plain bf16 {same[1]} "
                f"{flips(mp, again[1][1])}")
            attn.check(f"witness {cfg.name} {name}")
            if not all(same):
                fail(f"{cfg.name} witness {name}: a bf16 path run twice gave "
                     f"other logits (kernel, plain bit-equal: {same})")
            if not pinned[0] <= 2 * pinned[1] + 1e-3:
                fail(f"{cfg.name} witness {name}: with routing pinned the "
                     f"kernel path's error {pinned[0]} vs plain bf16 "
                     f"{pinned[1]}")
    log(f"# witness {cfg.name}: {len(prompts)} prompts, the rule broken "
        f"free on {broken or 'none'}, held on every one pinned, each bf16 "
        "path bit-reproducible")
    del p32


def combine_witness(torch, cfg, params, dev, runs: int = 20) -> None:
    """Phase 18's yardstick for the MoE combine: layer 0's MoE FFN on 512
    random bf16 tokens (a generator of its own), launched ``runs`` times,
    must give the same output every time (the port sums each token's k
    gated outputs in a fixed order, no atomics); the reference's
    scatter-add combine, ``index_add_`` of fp32 rows at the same routing's
    token indices (8 rows a token), is launched as often, and the launches
    whose sums differ from the first are counted (atomics on the card)."""
    from repro_torch.models import moe
    m, p, D = cfg.moe, params["blocks"][0]["moe"], cfg.d_model
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    x = torch.randn((512, D), generator=g, device=dev).to(cfg.tdtype)
    with torch.inference_mode():
        ys = [moe._local_moe(x, p["router"], p["wg"], p["wu"], p["wd"],
                             cfg=m)[0] for _ in range(runs)]
        _, mask, _, _ = moe._route(x, p["router"], m)
        tok = mask.nonzero(as_tuple=True)[0]
        src = torch.randn((tok.numel(), D), generator=g, device=dev)
        sums = [torch.zeros((512, D), device=dev).index_add_(0, tok, src)
                for _ in range(runs)]
    differ = sum(not torch.equal(ys[0], y) for y in ys[1:])
    atomics = sum(not torch.equal(sums[0], t) for t in sums[1:])
    log(f"# combine {cfg.name}: layer 0's MoE FFN relaunched {runs} times, "
        f"{differ} outputs differ from the first; the reference's "
        f"scatter-add (index_add_ of {tok.numel()} fp32 rows) {atomics} of "
        f"{runs - 1}")
    if differ:
        fail(f"{cfg.name}: the MoE combine is not reproducible ({differ} of "
             f"{runs - 1} relaunches differ)")


def granite_model_phase(torch, dev, gen, get_config) -> None:
    """Phase 18: ``model_phase`` on granite-moe-1b-a400m at full width and
    depth (24 layers, 16/8 heads of 64, 32 experts top-8), the float32
    reference upcast one block at a time, with each step's MoE routing
    reported (flips against the reference, drops per prefill) and every
    attention kernel call held against its plain version on the same
    inputs; first ``routing_witness`` on the phase's prompt and on a
    prompt from each of seeds 1-8 (generators of their own)."""
    from repro_torch.serving.backends import init_torch_params
    cfg = get_config(GRANITE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_torch_params(cfg, 0, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device=dev)
    prompts = [("phase 18's prompt", prompt)]
    for seed in range(1, 9):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        prompts.append((f"seed {seed}", torch.randint(
            0, cfg.vocab_size, (1, 512), generator=g, device=dev)))
    combine_witness(torch, cfg, params, dev)
    with RoutingTap() as tap, AttentionTap() as attn:
        routing_witness(torch, cfg, params, dev, prompts, tap, attn)
        model_phase(torch, cfg, dev, gen, tap=tap, prompt=prompt,
                    params=params, attn=attn)
    torch.cuda.synchronize()
    log(f"# phase model {GRANITE} ({cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.dh}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
        f"{n_params(params) / 1e9:.3f} B parameters): "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()


def paged_serve(serve, drive, sla, get_config, arch: str, path: str,
                handoff: int) -> dict:
    """Phases 19 and 25: ``arch`` served with phase 5's traffic; every
    prefill through flash and every decode step (and each of the 3
    engines' warm-up steps) through paged decode, once per layer exactly;
    no other kernel; each handoff one 512-token prompt's blocks, exactly
    ``handoff`` bytes (granite: 24 x 64 blocks x 8 rows x 8 heads x 64 x 2
    (K, V) x 2 bytes = 24 MiB; musicgen: 512 x 48 x 2 x 32 x 64 x 2 =
    192 MiB)."""
    cfg = get_config(arch)
    Lr, engines, requests = cfg.num_layers, 3, 16
    rec, n = drive(path, lambda: serve.main(["--arch", arch] + SERVE_ARGS))
    sla(rec)
    if rec["completed"] != requests:
        fail(f"{arch} serve completed {rec['completed']} of {requests}")
    if n["flash"] != Lr * rec["prefills"] or rec["prefills"] < requests:
        fail(f"{arch} serve: {n['flash']} flash launches for "
             f"{rec['prefills']} prefills of {Lr} layers")
    if n["paged"] != Lr * (rec["decode_steps"] + engines) \
            or rec["decode_steps"] < 1:
        fail(f"{arch} serve: {n['paged']} paged launches for "
             f"{rec['decode_steps']} decode steps + {engines} warm-ups of "
             f"{Lr} layers")
    if n["dense"] or n["wkv"]:
        fail(f"{arch} serve launched dense decode or WKV: {n}")
    moved = rec["transferred_MB"] * 2**20
    # a request the elastic matcher leaves on its prefill engine (turned
    # decode) is inserted there and moves nothing
    if 512 * cfg.kv_bytes_per_token() != handoff \
            or abs(moved - rec["transfers"] * handoff) > 0.5 \
            or not (rec["transfers"] == requests
                    or (rec.get("rate_matcher_moves")
                        and rec["transfers"] < requests)):
        fail(f"{arch} serve moved {moved} bytes in {rec['transfers']} "
             f"transfers; one handoff is {handoff} bytes")
    log(f"# {arch} serve (G = {cfg.q_group}, dh {cfg.dh}): flash "
        f"{n['flash']} = {Lr} x {rec['prefills']} prefills, paged "
        f"{n['paged']} = {Lr} x ({rec['decode_steps']} decode steps + "
        f"{engines} warm-ups); {rec['transfers']} handoffs x {handoff} bytes")
    return rec


def hymba_serve(serve, drive, sla, get_config) -> dict:
    """Phase 22: hymba-1.5b served disaggregated with phase 5's traffic;
    every prefill through flash (banded) and the selective scan, once per
    layer exactly, and every decode step (and each
    of the 3 engines' warm-up steps) through dense decode over the ring,
    once per layer exactly; no paged or WKV launch; each handoff the
    request's 1024-row ring K/V (32 x 1024 x 5 x 64 x 2 bytes x 2 =
    41,943,040) with ssm_h (32 x 1600 x 16 x 4 = 3,276,800) and conv (32 x
    3 x 1600 x 2 = 307,200): 45,527,040 bytes whatever the prompt."""
    cfg = get_config(HYMBA)
    Lr, engines, requests = cfg.num_layers, 3, 16
    rec, n = drive("serve-hymba", lambda: serve.main(
        ["--arch", HYMBA] + SERVE_ARGS))
    sla(rec)
    if rec["completed"] != requests:
        fail(f"hymba serve completed {rec['completed']} of {requests}")
    if n["flash"] != Lr * rec["prefills"] or rec["prefills"] < requests:
        fail(f"hymba serve: {n['flash']} flash launches for "
             f"{rec['prefills']} prefills of {Lr} layers")
    if n["scan"] != Lr * rec["prefills"]:
        fail(f"hymba serve: {n['scan']} selective-scan launches for "
             f"{rec['prefills']} prefills of {Lr} layers")
    if n["dense"] != Lr * (rec["decode_steps"] + engines) \
            or rec["decode_steps"] < 1:
        fail(f"hymba serve: {n['dense']} dense decode launches for "
             f"{rec['decode_steps']} decode steps + {engines} warm-ups of "
             f"{Lr} layers")
    if n["paged"] or n["wkv"]:
        fail(f"hymba serve launched paged decode or WKV: {n}")
    di = cfg.ssm_expand * cfg.d_model
    handoff = Lr * (2 * cfg.sliding_window * cfg.num_kv_heads * cfg.dh * 2
                    + di * cfg.ssm_state * 4 + (cfg.ssm_conv - 1) * di * 2)
    moved = rec["transferred_MB"] * 2**20
    # a request the elastic matcher leaves on its prefill engine (turned
    # decode) is inserted there and moves nothing
    if handoff != 45_527_040 or abs(moved - rec["transfers"] * handoff) > 0.5 \
            or not (rec["transfers"] == requests
                    or (rec.get("rate_matcher_moves")
                        and rec["transfers"] < requests)):
        fail(f"hymba serve moved {moved} bytes in {rec['transfers']} "
             f"transfers; one handoff is {handoff} bytes")
    log(f"# {HYMBA} serve: flash {n['flash']} and scan {n['scan']} = {Lr} x "
        f"{rec['prefills']} prefills, dense {n['dense']} = {Lr} x ({rec['decode_steps']} "
        f"decode steps + {engines} warm-ups); {rec['transfers']} handoffs x "
        f"{handoff} bytes (ring K/V, ssm_h, conv) = {moved:.0f} bytes")
    return rec


def musicgen_model_phase(torch, dev, gen, get_config) -> None:
    """Phase 24: ``model_phase`` on musicgen-large at full width and depth
    (48 layers, 32/32 heads of 64, vocabulary 2048), the float32 reference
    upcast one block at a time, every flash and paged decode call held
    against its plain version on the same inputs (``AttentionTap``)."""
    cfg = get_config(MUSICGEN)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with AttentionTap() as attn:
        params = model_phase(torch, cfg, dev, gen, attn=attn)
    torch.cuda.synchronize()
    log(f"# phase model {MUSICGEN} ({cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.dh}, G = "
        f"{cfg.q_group}, vocabulary {cfg.vocab_size}, "
        f"{n_params(params) / 1e9:.4f} B parameters): "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()


def kvquant_model_phase(torch, dev, gen, get_config, B: int = 4,
                        S: int = 512, steps: int = 4) -> None:
    """Phase 26: qwen2.5-3b with ``kv_quant=True`` at full width and depth
    (the weights of phase 4, seed 0): a prefill of B prompts of S tokens
    into an int8 cache and dense decode steps from each path's own cache,
    three ways: kernel kv-quant bf16, plain kv-quant bf16 and, as the
    reference, the unquantized model in float32 (upcast one block at a
    time), held by ``hold``; every flash and dense decode call held
    against its plain version on the same (dequantized) inputs. Layer 0
    sees the same inputs on both bf16 paths, so its int8 K/V and scales
    must be equal bit for bit between them after the prefill and after
    the steps."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params
    base = get_config("qwen2.5-3b")
    cfg = base.replace(kv_quant=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_torch_params(base, 0, device=dev)
    runs = [(params, cfg, "kernel"), (params, cfg, "plain"),
            (upcast(params), base.replace(dtype="float32"), "plain")]
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    cap = S + steps + 8

    def same_layer0(what, ck, cp):
        same = all(torch.equal(ck[k][0], cp[k][0])
                   for k in ("k", "v", "k_scale", "v_scale"))
        log(f"# model {cfg.name} kv-quant {what}: layer 0's int8 K/V and "
            f"scales bit-identical between the kernel and plain paths: "
            f"{same}")
        if not same:
            fail(f"kv-quant {what}: layer 0's int8 cache differs between "
                 "the kernel and plain paths")

    with torch.inference_mode(), AttentionTap() as attn:
        out = [T.prefill_full(p, c, {"tokens": prompt}, capacity=cap,
                              impl=impl) for p, c, impl in runs]
        hold(torch, f"{cfg.name} kv-quant prefill B={B} S={S}",
             cfg.num_layers, *(lg for lg, _ in out), cfg.vocab_size)
        attn.check(f"model {cfg.name} kv-quant prefill")
        caches = [c for _, c in out]
        if caches[0]["k"].dtype != torch.int8:
            fail(f"kv-quant cache is {caches[0]['k'].dtype}, not int8")
        same_layer0("prefill", caches[0], caches[1])
        toks = out[2][0][:, :cfg.vocab_size].argmax(-1)
        for step in range(steps):
            logits = [T.decode_step(p, c, cache, toks, impl=impl)[0]
                      for (p, c, impl), cache in zip(runs, caches)]
            hold(torch, f"{cfg.name} kv-quant decode step {step}",
                 cfg.num_layers, *logits, cfg.vocab_size)
            attn.check(f"model {cfg.name} kv-quant decode step {step}")
            toks = logits[2][:, :cfg.vocab_size].argmax(-1)
        same_layer0(f"after {steps} decode steps", caches[0], caches[1])
    nbytes = {name: sum(c[k].numel() * c[k].element_size()
                        for k in T.cache_stacks(c_cfg))
              for name, c, c_cfg in (("int8", caches[0], cfg),
                                     ("fp32", caches[2], runs[2][1]))}
    torch.cuda.synchronize()
    log(f"# phase model {cfg.name} kv-quant: cache bytes {nbytes}, "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, runs, caches, out
    torch.cuda.empty_cache()


def kvquant_serve(torch, drive, sla, get_config, dev, dense_rec) -> None:
    """Phase 27: phase 8's dense serve on the kv-quant configuration. Every
    request completes; dense decode ran exactly once per layer per decode
    step and per engine's warm-up step, flash once per layer per prefill,
    paged decode never; each handoff is exactly 130/256 of phase 8's bf16
    one: int8 values and a bf16 scale per token and KV head, (1 + 2/128)
    / 2. Then phase 11's profile of a kv-quant dense engine, with the
    dequantization's device time per step (``kv_dequant`` spans around
    ``transformer._kv_dequant``)."""
    cfg = get_config("qwen2.5-3b").replace(kv_quant=True)
    Lr, engines = cfg.num_layers, 2
    rec, n = drive("dense-kvquant", lambda: dense_serve(torch, cfg, dev,
                                                        False, {}))
    sla(rec)
    if rec["completed"] != 4:
        fail(f"kv-quant serve completed {rec['completed']} of 4")
    if n["dense"] != Lr * (rec["decode_steps"] + engines) \
            or n["flash"] != Lr * rec["prefills"] or n["paged"] or n["wkv"] \
            or rec["decode_steps"] < 1:
        fail(f"kv-quant serve: launches {n} for {rec['prefills']} prefills "
             f"and {rec['decode_steps']} decode steps + {engines} warm-ups")
    per = rec["transferred_MB"] * 2**20 / rec["transfers"]
    bf16 = dense_rec["transferred_MB"] * 2**20 / dense_rec["transfers"]
    if per * 256 != bf16 * 130 or rec["transfers"] != 4:
        fail(f"kv-quant handoff {per} bytes, phase 8's {bf16}: not 130/256")
    log(f"# kv-quant serve: dense {n['dense']} = {Lr} x ({rec['decode_steps']}"
        f" decode steps + {engines} warm-ups), flash {n['flash']}; "
        f"{rec['transfers']} handoffs x {per:.0f} bytes = 130/256 x phase "
        f"8's {bf16:.0f}")
    profile_phase(torch, cfg, dev, paged=False)


def speculative_phase(torch, dev, drive, get_config, N: int = 64,
                      S: int = 512) -> None:
    """Phase 28: speculative decoding with qwen2.5-3b (the weights of phase
    4) as the target and a draft of its first ``DRAFT_LAYERS`` blocks (the
    same embed, final norm and head), a prompt of S tokens (a generator of
    its own), N tokens, k = ``SPEC_K``.

    - Plain float32: the tokens equal the target's own greedy decode
      (``decode_step``) exactly, and so does a self-draft, which accepts
      every proposal.
    - Kernel bf16, counted: flash ran exactly once per target layer per
      target call (the prefill and each verify pass: 4 query rows at
      ``q_offset``) plus once per draft layer per draft prefill (the first
      and each re-prefill after a rejection), dense decode once per draft
      layer per draft step, nothing else. The prefix on which the tokens
      agree with the target's bf16 greedy decode is printed; at the first
      disagreement, if any, the speculative token's logit in the greedy
      decode must lie within ``NEAR_TIE`` x max(1, logit scale) of the top
      one (a bf16 near-tie: the verify pass and the decode step round
      differently). The self-draft's acceptance is printed.
    - Acceptance, target calls and tokens per second beside the target's
      greedy decode on the same path."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.backends import init_torch_params
    from repro_torch.serving.speculative import speculative_decode
    cfg = get_config("qwen2.5-3b")
    V, Lr = cfg.vocab_size, cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    params = init_torch_params(cfg, 0, device=dev)
    g = torch.Generator().manual_seed(28)
    prompt = torch.randint(0, V, (S,), generator=g).numpy()

    def draft_of(p, c):
        return (dict(p, blocks=p["blocks"][:DRAFT_LAYERS]),
                c.replace(num_layers=DRAFT_LAYERS))

    def greedy(p, c, impl):
        """The target's greedy decode: its tokens, each step's logits and
        tokens per second."""
        t0 = time.perf_counter()
        lg, cache = T.prefill_full(p, c, {"tokens": torch.as_tensor(
            prompt, device=dev)[None]}, capacity=S + N + 8, impl=impl)
        rows = [lg[0, :V]]
        while len(rows) < N:
            tok = rows[-1].argmax()[None]
            lg, cache = T.decode_step(p, c, cache, tok, impl=impl)
            rows.append(lg[0, :V])
        toks = torch.stack(rows).argmax(-1).tolist()
        return toks, rows, N / (time.perf_counter() - t0)

    def spec(p, c, dp, dc, impl):
        t0 = time.perf_counter()
        toks, stats = speculative_decode(p, c, dp, dc, prompt, N, k=SPEC_K,
                                         impl=impl)
        torch.cuda.synchronize()
        return toks, stats, N / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    with torch.inference_mode():
        p32 = {k: (v.float() if k != "blocks" else
                   [upcast_tree(b) for b in v]) for k, v in params.items()}
        c32 = cfg.replace(dtype="float32")
        ref32, _, _ = greedy(p32, c32, "plain")
        toks, stats, _ = spec(p32, c32, *draft_of(p32, c32), "plain")
        self_toks, self_stats, _ = spec(p32, c32, p32, c32, "plain")
    log(f"# speculative fp32 plain: {DRAFT_LAYERS}-layer draft {stats}, "
        f"tokens equal the greedy decode: {toks == ref32}; self-draft "
        f"{self_stats}, equal: {self_toks == ref32}")
    if toks != ref32 or self_toks != ref32 \
            or self_stats["accepted"] != self_stats["proposed"]:
        fail("speculative decoding in float32 is not the target's greedy "
             "decode, or the self-draft rejected a proposal")
    del p32
    torch.cuda.empty_cache()

    with torch.inference_mode():
        ref, rows, greedy_tps = greedy(params, cfg, "kernel")
        prefills = []
        orig = T.prefill_full

        def counted(p, c, *args, **kw):
            prefills.append(c.num_layers)
            return orig(p, c, *args, **kw)

        T.prefill_full = counted
        try:
            (toks, stats, tps), n = drive("speculative", lambda: spec(
                params, cfg, *draft_of(params, cfg), "kernel"))
        finally:
            T.prefill_full = orig
        self_toks, self_stats, self_tps = spec(params, cfg, params, cfg,
                                               "kernel")
    draft_prefills = prefills.count(DRAFT_LAYERS)
    want = {"flash": Lr * stats["target_calls"]
            + DRAFT_LAYERS * draft_prefills,
            "dense": DRAFT_LAYERS * stats["draft_calls"], "paged": 0,
            "wkv": 0, "scan": 0}
    agree = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                 N)
    log(f"# speculative bf16 kernel: {DRAFT_LAYERS}-layer draft {stats}, "
        f"acceptance {stats['accepted'] / stats['proposed']:.3f}, "
        f"{draft_prefills - 1} draft re-prefills, launches {n} (want "
        f"{want}); {tps:.2f} tokens/s against the greedy decode's "
        f"{greedy_tps:.2f}; the first {agree} of {N} tokens agree with it; "
        f"self-draft {self_stats}, acceptance "
        f"{self_stats['accepted'] / self_stats['proposed']:.3f}, "
        f"{self_tps:.2f} tokens/s; {time.perf_counter() - t0:.1f} s")
    if n != want or prefills.count(Lr) != 1:
        fail(f"speculative launches {n}, want {want}")
    if agree < N:
        lg = rows[agree]
        gap = (lg.max() - lg[toks[agree]]).item()
        tol = NEAR_TIE * max(1.0, lg.abs().max().item())
        log(f"# speculative bf16: at token {agree} the greedy decode's top "
            f"logit leads the speculative token's by {gap:.4e} (near-tie "
            f"bound {tol:.4e})")
        if not gap <= tol:
            fail(f"speculative bf16 token {agree} is no near-tie of the "
                 f"greedy decode's: {gap} > {tol}")
    del params


class UpcastOnUse:
    """A bf16 leaf of the float32 reference, upcast only where the model
    reads it: embedding rows by index, the LM head whole for the logits'
    product (then freed). llava's embedding and head in float32 would
    take 3.4 GiB beside its 64.2 GiB of bf16 weights."""

    def __init__(self, t):
        self.t = t

    def __getitem__(self, idx):
        return self.t[idx].float()

    def float(self):
        return self.t.float()


def llava_model_phase(torch, dev, get_config, steps: int = 4) -> None:
    """Phase 29: llava-next-34b at full width and depth (60 layers, 56/8
    heads of 128: G = 7), bf16, random weights from seed 0. The input is
    ``synth_inputs`` at the vision prompt's shape: 2,880 patch embeddings
    (projected by ``vis_proj`` and prepended) and 512 text tokens, 3,392
    positions; ``prefill_full`` over it, then paged decode steps for one
    slot holding its cache, three ways by phase 4's rule (kernel bf16,
    plain bf16, plain float32 upcast one block at a time, its embedding
    and head only where read), every flash and paged decode call held
    against its plain version on the same inputs (``AttentionTap``). The
    bf16 prefill caches wait on the host while the float32 prefill runs;
    peak memory printed. Everything is freed on return: a second copy of
    the weights does not fit beside the serve's."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.frontends import synth_inputs
    from repro_torch.serving.backends import init_torch_params
    cfg = get_config(LLAVA)
    c32 = cfg.replace(dtype="float32")
    Lr, V, P = cfg.num_layers, cfg.vocab_size, cfg.vision_patches
    S = P + LLAVA_TEXT
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_torch_params(cfg, 0, device=dev)
    inputs = synth_inputs(cfg, ShapeConfig("vision", S, 1, "prefill"), 0,
                          device=dev)
    torch.cuda.synchronize()
    log(f"# model {LLAVA}: {n_params(params):,} parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of bf16 weights "
        f"on the card ({time.perf_counter() - t0:.1f} s to draw)")
    p32 = {"embed": UpcastOnUse(params["embed"]),
           "lm_head": UpcastOnUse(params["lm_head"]),
           "final_norm": params["final_norm"].float(),
           "vis_proj": upcast_tree(params["vis_proj"]),
           "blocks": UpcastBlocks(params["blocks"])}
    what = f"{LLAVA} prefill S={S} ({P} patches + {LLAVA_TEXT} tokens)"
    with AttentionTap() as attn, torch.inference_mode():
        lk, ck = T.prefill_full(params, cfg, inputs, impl="kernel")
        attn.check(f"model {what}")
        lp, cp = T.prefill_full(params, cfg, inputs, impl="plain")
        ck, cp = tree_to(ck, "cpu"), tree_to(cp, "cpu")
        lr, cr = T.prefill_full(p32, c32, inputs, impl="plain")
        hold(torch, what, Lr, lk, lp, lr, V)
        pools, tables, pos = paged_slots(torch, T, (cfg, cfg, c32),
                                         (ck, cp, cr), S, dev, slots=1)
        del ck, cp, cr
        toks = lr[:, :V].argmax(-1)
        for step in range(steps):
            dk, _, _ = T.decode_step_paged(params, cfg, pools[0], tables,
                                           pos, toks, impl="kernel")
            attn.check(f"model {LLAVA} decode step {step}")
            dp, _, _ = T.decode_step_paged(params, cfg, pools[1], tables,
                                           pos, toks, impl="plain")
            dr, _, _ = T.decode_step_paged(p32, c32, pools[2], tables, pos,
                                           toks, impl="plain")
            hold(torch, f"{LLAVA} decode step {step}", Lr, dk, dp, dr, V)
            pos, toks = pos + 1, dr[:, :V].argmax(-1)
    torch.cuda.synchronize()
    log(f"# phase model {LLAVA} ({Lr} layers, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.dh}, G = {cfg.q_group}, a "
        f"{S}-position vision prompt): {time.perf_counter() - t0:.1f} s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _finite(torch, *xs) -> bool:
    return all(bool(torch.isfinite(torch.as_tensor(x)).all()) for x in xs)


def train_phase(torch, dev, drive, get_config, steps: int = 5, B: int = 4,
                S: int = 512) -> None:
    """Phase 31: training at full width; no hand-written kernel may launch
    (none has a backward).

    - qwen2.5-3b at full depth: the ``Trainer`` (AdamW, remat on) on
      batches of B x S, ``steps`` steps; loss, grad norm, step seconds
      (ending in a device synchronise), tokens/s and peak memory, beside
      the step's bound (6 x params x tokens of bf16 work at 989 TFLOP/s, 8
      x with remat's second forward). The run keeps no checkpoint (its
      40.8 GB of state): phase 32 checks that path.
    - qwen2.5-3b at full width and 4 layers: step 0's bf16 loss and grads
      against a float32 upcast of the same weights by ``TRAIN_RULE``;
      then 12 AdamW steps at ``DESCEND_LR``, warmup 2, on batches 0 and 1
      in turn (the reference's ``test_optimizer_decreases_loss``) must
      lower the loss.
    - granite-moe-1b-a400m, rwkv6-1.6b and hymba-1.5b at full width and 4
      layers: 2 steps each, finite, the MoE metrics printed: their first
      backward on the card, through the MoE dispatch, the plain WKV and
      the SSM scan."""
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import loss_and_grad, make_train_step
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import flatten_with_paths

    def no_launch(path, n):
        if any(n.values()):
            fail(f"{path}: kernels launched in a training step: {n}")

    cfg = get_config("qwen2.5-3b")
    if not cfg.remat or cfg.optimizer != "adamw":
        fail(f"{cfg.name}: expected remat and AdamW, got {cfg.remat}, "
             f"{cfg.optimizer}")
    N, tokens = cfg.param_count(), B * S
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def full_depth():
        tr = Trainer(cfg, make_pipeline(cfg, S, B, device=dev),
                     ckpt_dir=ckpt_dir, ckpt_every=10 ** 9, device=dev)
        tr.checkpoint = lambda: None
        tr.train(steps)
        return tr

    try:
        tr, n = drive("train-qwen", full_depth)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    no_launch("train-qwen", n)
    peak = torch.cuda.max_memory_allocated()
    hist = tr.history
    train_split(torch, tr, cfg, steps)
    del tr
    for h in hist:
        log(f"# train {cfg.name} step {h['step']}: loss {h['loss']:.4f} "
            f"grad_norm {h['grad_norm']:.4f} step {h['step_s'] * 1e3:.1f} ms "
            f"{tokens / h['step_s']:.0f} tokens/s")
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train {cfg.name}: non-finite step {h}")
    warm = sorted(h["step_s"] for h in hist[1:])
    log(f"# train {cfg.name} ({cfg.num_layers} layers, {N:,} parameters, "
        f"B={B} S={S}, AdamW, remat): median step of steps 1-"
        f"{len(hist) - 1} {warm[len(warm) // 2] * 1e3:.1f} ms, "
        f"{tokens / warm[len(warm) // 2]:.0f} tokens/s; bound "
        f"{6 * N * tokens / PEAK_BF16_FLOPS * 1e3:.1f} ms (6 N T), "
        f"{8 * N * tokens / PEAK_BF16_FLOPS * 1e3:.1f} ms with remat "
        f"(8 N T); peak memory {peak / 2**30:.2f} GiB, "
        f"{peak / N:.1f} B per parameter")

    # 4 layers: bf16 against float32, then the loss must fall
    c4 = cfg.replace(num_layers=4)
    params = T.init_params(c4, 0, device=dev)
    data = make_pipeline(c4, S, B, device=dev)

    def rule():
        b0 = data.batch_at(0)
        l16, _, g16 = loss_and_grad(params, c4, b0)
        p32 = {k: (v.float() if torch.is_tensor(v) else
                   [upcast_tree(b) for b in v]) for k, v in params.items()}
        l32, _, g32 = loss_and_grad(p32, c4.replace(dtype="float32"), b0)
        del p32
        leaf = {}
        d2 = r2 = 0.0
        for (path, a), (_, b) in zip(flatten_with_paths(g16),
                                     flatten_with_paths(g32)):
            d, r = (a - b).double().norm().item(), b.double().norm().item()
            leaf[path] = d / max(r, 1e-30)
            d2, r2 = d2 + d * d, r2 + r * r
        return float(l16), float(l32), (d2 / r2) ** 0.5, leaf

    (l16, l32, grads, leaf), n = drive("train-bf16-vs-fp32", rule)
    no_launch("train-bf16-vs-fp32", n)
    worst = sorted(leaf.items(), key=lambda kv: -kv[1])[:3]
    loss_err = abs(l16 - l32) / abs(l32)
    log(f"# train {c4.name} 4 layers bf16 vs fp32, step 0: loss {l16:.5f} "
        f"vs {l32:.5f} (rel {loss_err:.2e}, rule {TRAIN_RULE['loss']}); "
        f"grads rel L2 {grads:.3e} (rule {TRAIN_RULE['grads']}); worst "
        f"leaves " + ", ".join(f"{k} {e:.3e}" for k, e in worst)
        + f" (rule {TRAIN_RULE['leaf']})")
    if not (loss_err <= TRAIN_RULE["loss"] and grads <= TRAIN_RULE["grads"]
            and worst[0][1] <= TRAIN_RULE["leaf"]):
        fail(f"bf16 train step off float32: loss {loss_err}, grads {grads}, "
             f"worst leaf {worst[0]}")

    def descend():
        opt = make_optimizer("adamw", lr=DESCEND_LR, warmup=2)
        state, step_fn, out = opt.init(params), make_train_step(c4, opt), []
        for i in range(12):
            _, state, m = step_fn(params, state, data.batch_at(i % 2), i)
            out.append(float(m["loss"]))
        return out

    losses, n = drive("train-descend", descend)
    no_launch("train-descend", n)
    log(f"# train {c4.name} 4 layers, 12 AdamW steps at lr {DESCEND_LR} on "
        f"batches 0/1: losses {[round(x, 4) for x in losses]}")
    if not (_finite(torch, losses) and losses[-1] < losses[0]):
        fail(f"train: the loss did not fall over 12 steps: {losses}")
    del params, data

    for arch in (GRANITE, "rwkv6-1.6b", HYMBA):
        ca = get_config(arch).replace(num_layers=4)

        def two_steps():
            p = T.init_params(ca, 0, device=dev)
            opt = make_optimizer("adamw", lr=1e-3, warmup=1)
            state, step_fn = opt.init(p), make_train_step(ca, opt)
            d = make_pipeline(ca, S, B, device=dev)
            out = []
            for i in range(2):
                t1 = time.perf_counter()
                _, state, m = step_fn(p, state, d.batch_at(i), i)
                torch.cuda.synchronize()
                out.append({k: float(v) for k, v in m.items()}
                           | {"step_s": time.perf_counter() - t1})
            return out

        hist, n = drive(f"train-{arch}", two_steps)
        no_launch(f"train-{arch}", n)
        for i, m in enumerate(hist):
            log(f"# train {arch} 4 layers step {i}: " + json.dumps(
                {k: round(v, 5) for k, v in m.items()}))
            if not _finite(torch, list(m.values())):
                fail(f"train {arch}: non-finite metrics {m}")


def train_split(torch, tr, cfg, step: int) -> None:
    """Where one more step of ``tr`` goes: host seconds (each part ending
    in a device synchronise) of the loss and its fp32 grads, the clip and
    the optimizer update; then a whole step's device busy time from the
    profiler and the idle share beside its host time."""
    from repro_torch.train.optimizer import clip_by_global_norm
    from repro_torch.train.train_step import loss_and_grad
    batch = tr.data.batch_at(step)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (_, _, grads), t_grad = timed(lambda: loss_and_grad(tr.params, cfg,
                                                        batch))
    (grads, _), t_clip = timed(lambda: clip_by_global_norm(grads, 1.0))
    with torch.no_grad():
        _, t_update = timed(lambda: tr.opt.update(grads, tr.opt_state,
                                                  tr.params, step))
    del grads
    step_fn = functools.partial(tr._step_fn, tr.params, tr.opt_state, batch)
    _, t_step = timed(lambda: step_fn(step))
    busy = Timer(torch).device(step_fn, [(step,)])
    log(f"# train {cfg.name} one step split: loss + grads {t_grad * 1e3:.1f} "
        f"ms, clip {t_clip * 1e3:.1f} ms, AdamW update "
        f"{t_update * 1e3:.1f} ms; a whole step {t_step * 1e3:.1f} ms, device "
        f"busy " + (f"{busy:.1f} ms (idle share "
                    f"{1 - busy / (t_step * 1e3):.3f})" if busy else
                    "not measured"))


def train_launcher_phase(torch, dev, drive, get_config,
                         arch: str = "qwen2.5-3b") -> None:
    """Phase 32: the launcher and the checkpoint on the card, at smoke
    size. A ``Trainer`` set up as ``launch.train`` sets one up (its
    defaults: 64 x 8 batches, lr 3e-3) checkpoints every 4 steps and
    crashes at step 6 (``fail_at``); ``launch.train.main --device cuda``
    resumes it from step 4 to 10; a second launcher run trains 10 steps
    fresh. The resumed parameters must lie within ``RESUME_ATOL`` of the
    fresh ones; whether they are bit-equal is printed (CUDA's
    index-accumulating backward kernels may add in no fixed order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import train
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves
    smoke = get_smoke_config(arch)
    flags = ["--arch", arch, "--steps", "10", "--device", str(dev),
             "--ckpt-every", "4"]
    dirs = [tempfile.mkdtemp(prefix="chip_smoke_ckpt_") for _ in range(2)]

    def run():
        crashed = Trainer(smoke, make_pipeline(smoke, 64, 8, device=dev),
                          ckpt_dir=dirs[0], ckpt_every=4, lr=3e-3,
                          device=dev)
        try:
            crashed.train(10, fail_at=6)
        except RuntimeError as e:
            log(f"# launcher: {e}")
        else:
            fail("the trainer did not crash at step 6")
        return (train.main(flags + ["--ckpt-dir", dirs[0]]),
                train.main(flags + ["--ckpt-dir", dirs[1]]))

    try:
        (resumed, fresh), n = drive("train-launcher", run)
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    if any(n.values()):
        fail(f"train-launcher: kernels launched: {n}")
    if resumed.history[0]["step"] != 4 or resumed.step != 10 \
            or fresh.step != 10:
        fail(f"launcher: resumed from {resumed.history[0]['step']} to "
             f"{resumed.step}, fresh to {fresh.step}")
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(leaves(resumed.params), leaves(fresh.params)))
    same = all(torch.equal(a, b) for a, b in zip(leaves(resumed.params),
                                                leaves(fresh.params)))
    losses = [(h["loss"], g["loss"]) for h, g in zip(
        resumed.history, fresh.history[4:])]
    log(f"# launcher {smoke.name} on the card: crash at 6, resumed 4 -> 10; "
        f"resumed vs fresh parameters max abs diff {diff:.3e} (bound "
        f"{RESUME_ATOL}), bit-equal {same}; losses of steps 4-9 equal "
        f"{all(a == b for a, b in losses)}")
    if not diff <= RESUME_ATOL:
        fail(f"resumed parameters off the fresh run's by {diff}")



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


def host_env() -> dict:
    """A child process's environment: the repository's sources, no card."""
    return dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")


def dryrun_host_phase() -> None:
    """Phase 33: ``python -m repro_torch.launch.dryrun`` on this host, one
    serve cell per family on the 16x16 mesh (a fake process group of 512
    ranks; the card is not touched), each in a process of its own, all at
    once. Fails unless every cell is ``ok`` with the JAX package's
    per-device argument bytes (``DRYRUN_ARG_BYTES``); prints each one's
    per-device peak, collectives and trace seconds."""
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    procs = {}
    for arch, shape, variant in DRYRUN_ARG_BYTES:
        procs[(arch, shape, variant)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--variant",
             variant, "--out", out, "--force"], env=host_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    failed = []
    for cell, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        arch, shape, variant = cell
        tag = f"{arch}__{shape}__single" + (
            f"__{variant}" if variant != "base" else "")
        path = os.path.join(out, tag + ".json")
        if proc.returncode != 0 or not os.path.exists(path):
            failed.append(f"{tag}: exit {proc.returncode} {err[-400:]}")
            continue
        with open(path) as f:
            rec = json.load(f)
        mem = rec["memory"]
        log(f"# dryrun {tag}: {rec['status']}, argument "
            f"{mem['argument_bytes']:,} B, peak/device "
            f"{mem['peak_per_device'] / 2**30:.3f} GiB, collectives "
            + json.dumps({k: v["count"] for k, v in
                          rec["collectives"].items()})
            + f", traced in {rec['compile_s']} s")
        want = DRYRUN_ARG_BYTES[cell]
        if rec["status"] != "ok" or mem["argument_bytes"] != want:
            failed.append(f"{tag}: {rec['status']}, argument bytes "
                          f"{mem['argument_bytes']} against {want}")
    shutil.rmtree(out, ignore_errors=True)
    if failed:
        fail("dry run: " + "; ".join(failed))


# phase 34's cells of the dry run, sized to one card: qwen2.5-3b prefill of
# 2 x 4,096 and a dense decode step of 16 slots over a capacity of 8,192
DRYRUN_CARD_CELLS = {"prefill": (4096, 2), "decode": (8192, 16)}
# a dry run that undercounts says a sharding fits when it does not: its
# peak must reach this share of the card's
DRYRUN_PEAK_FLOOR = 0.9

_DRYRUN_CARD = r"""
import json, sys, tempfile
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models.config import ShapeConfig
mesh = make_fake_mesh((1, 1), ("data", "model"))
cfg = get_config("qwen2.5-3b")
out = {}
with tempfile.TemporaryDirectory() as tmp:
    for kind, (S, B) in json.loads(sys.argv[1]).items():
        out[kind] = run_cell(cfg.name, kind + "_card", "1x1", tmp,
                             force=True, cfg=cfg,
                             shape=ShapeConfig(kind + "_card", S, B, kind),
                             mesh=mesh)
print(json.dumps(out))
"""


def analysis_phase(smi: str) -> None:
    """Phase 35: the port's static passes over this checkout, on the
    host, and the import hygiene of the modules they keep torch-free."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"],
        capture_output=True, text=True, env=host_env(), cwd=ROOT,
        timeout=300)
    try:
        rec = json.loads(proc.stdout)
    except ValueError:
        fail(f"analysis: exit {proc.returncode}, no JSON: "
             f"{proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    n_files = sum(1 for top in ("src", "tests")
                  for _, _, files in os.walk(os.path.join(ROOT, top))
                  for f in files if f.endswith(".py"))
    with open(os.path.join(SRC, "repro_torch", "analysis",
                           "baseline.json")) as f:
        budget = sum(int(e.get("count", 1)) for e in json.load(f)["accepted"])
    passes = ", ".join(f"{name} {t * 1e3:.1f}"
                       for name, t in rec["timings"].items())
    log(f"# analysis: {rec['checked_modules']} modules ({n_files} files), "
        f"{len(rec['violations'])} new, {len(rec['baselined'])} baselined "
        f"(budget {budget}); per pass, ms of the host's clock: {passes} "
        f"| {smi}")
    if proc.returncode != 0 or not rec["ok"]:
        fail(f"analysis: exit {proc.returncode}, new findings "
             + json.dumps(rec["violations"])[:2000])
    if rec["checked_modules"] != n_files:
        fail(f"analysis: checked {rec['checked_modules']} modules of "
             f"{n_files} .py files under src/ and tests/")
    if len(rec["baselined"]) != budget:
        fail(f"analysis: {len(rec['baselined'])} baselined findings against "
             f"a budget of {budget}")
    code = ("import sys, repro_torch.analysis.__main__, "
            "repro_torch.serving.speculative; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=host_env(), cwd=ROOT, timeout=120)
    if proc.returncode != 0 or proc.stdout.strip() != "[]":
        fail(f"analysis: importing the passes and speculative decoding "
             f"loaded {proc.stdout.strip()[:500]} {proc.stderr[-500:]}")
    log("# analysis: repro_torch.analysis.__main__ and "
        "repro_torch.serving.speculative import without torch")


def storage_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages under nested dicts and lists."""
    seen = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    for tree in trees:
        walk(tree)
    return sum(seen.values())


def dryrun_card_phase(torch, dev, drive, get_config) -> None:
    """Phase 34: the dry run's prediction against the H100.

    qwen2.5-3b at full width and depth, random bf16 weights from seed 0.
    For each of ``DRYRUN_CARD_CELLS``: the dry run on a fake 1x1 mesh (a
    child process, as a process keeps one default group); the step it
    traced (``impl="xla"``: the reference's lowering, a prompt's attention
    the blocked online softmax) on the card between resets of the peak
    (``torch.cuda.max_memory_allocated``); fails unless the argument bytes
    equal those of the params, inputs and cache on the card exactly and
    the predicted peak is at least ``DRYRUN_PEAK_FLOOR`` of the measured
    one. The plain path's peak is printed beside it (its prefill holds
    the whole score tensor). Then the kernel path between launch counters
    (flash exactly once per layer per prefill, kernel 3 once per layer
    per decode step), its logits held to the plain path's by phase 4's
    rule against a float32 upcast, its peak printed beside the
    prediction; and once more outside the counters under
    ``AttentionTap``, which holds each flash and kernel 3 call to its
    plain version on the same inputs at ``KERNEL_ATOL``. Last, the plain
    prefill under ``use_mesh(make_host_mesh())``: a one-rank NCCL group,
    DTensor parameters on the card, logits bit-equal to the plain prefill
    without a mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import placements_for, use_mesh
    from repro_torch.parallel.specs import distribute_params
    from repro_torch.serving.backends import init_torch_params

    child = subprocess.run(
        [sys.executable, "-c", _DRYRUN_CARD, json.dumps(DRYRUN_CARD_CELLS)],
        env=host_env(), capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        fail(f"phase 34 dry run: {child.stderr[-2000:]}")
    pred = json.loads(child.stdout.strip().splitlines()[-1])
    for kind, rec in pred.items():
        if rec["status"] != "ok":
            fail(f"phase 34 dry run {kind}: {rec.get('error')}")
        log(f"# dryrun card-cell {kind}: traced in {rec['compile_s']} s, "
            "memory " + json.dumps(rec["memory"]))

    cfg = get_config("qwen2.5-3b")
    Lr = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    params = init_torch_params(cfg, 0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(34)
    S, B = DRYRUN_CARD_CELLS["prefill"]
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev,
                         dtype=torch.int32)
    C, Bd = DRYRUN_CARD_CELLS["decode"]
    caches = [T.init_cache(cfg, Bd, C, device=dev) for _ in range(2)]
    for key in ("k", "v"):      # 4,096 cached positions a slot, then one
        caches[0][key].normal_(generator=g)
    caches[0]["pos"].fill_(C // 2)
    caches[1] = {k: v.clone() for k, v in caches[0].items()}
    dtoks = torch.randint(0, cfg.vocab_size, (Bd,), generator=g, device=dev,
                          dtype=torch.int32)
    args = {"prefill": (params, {"tokens": toks}),
            "decode": (params, caches[0], dtoks)}

    def step(kind, impl, cache):
        if kind == "prefill":
            return T.prefill_full(params, cfg, {"tokens": toks}, impl=impl)
        cache["pos"].fill_(C // 2)      # a decode step writes row C // 2
        return T.decode_step(params, cfg, cache, dtoks, impl=impl)

    def measure(fn):
        """(the step's output, its peak: the arguments' bytes plus the
        most it allocated above them)."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - before

    logits = {}
    for kind in ("prefill", "decode"):
        rec = pred[kind]["memory"]
        arg = storage_bytes(torch, *args[kind])
        out, above = measure(lambda: step(kind, "xla", caches[0]))
        del out
        measured = arg + above
        ratio = rec["peak_per_device"] / measured
        out, above = measure(lambda: step(kind, "plain", caches[0]))
        logits[kind, "plain"] = out[0]
        del out
        log(f"# dryrun card {kind}: argument bytes predicted "
            f"{rec['argument_bytes']:,} on the card {arg:,}; peak predicted "
            f"{rec['peak_per_device'] / 2**30:.3f} GiB, the traced step "
            f"(xla) on the card {measured / 2**30:.3f} GiB, ratio "
            f"{ratio:.3f}; the plain path {(arg + above) / 2**30:.3f} GiB")
        if rec["argument_bytes"] != arg:
            fail(f"phase 34 {kind}: argument bytes {rec['argument_bytes']} "
                 f"predicted, {arg} on the card")
        if ratio < DRYRUN_PEAK_FLOOR:
            fail(f"phase 34 {kind}: predicted peak {ratio:.3f} of the "
                 "card's")

        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        with torch.inference_mode():
            out, n = drive(f"dryrun-card-{kind}",
                           lambda: step(kind, "kernel", caches[1]))
        kpeak = arg + torch.cuda.max_memory_allocated() - before
        logits[kind, "kernel"] = out[0]
        want = {"prefill": {"flash": Lr}, "decode": {"dense": Lr}}[kind]
        others = {k: v for k, v in n.items() if k not in want}
        if any(n[k] != v for k, v in want.items()) or any(others.values()):
            fail(f"phase 34 {kind}: launches {n}, want {want} and no other")
        log(f"# dryrun card {kind}: kernel path peak {kpeak / 2**30:.3f} "
            f"GiB beside the prediction's "
            f"{rec['peak_per_device'] / 2**30:.3f}")
        del out
        with torch.inference_mode(), AttentionTap() as attn:
            step(kind, "kernel", caches[1])
        attn.check(f"dryrun-card {kind}")

    # the float32 reference, weights upcast a block at a time
    c32, p32 = cfg.replace(dtype="float32"), upcast(params)
    cache32 = {k: (v.float() if v.is_floating_point() else v.clone())
               for k, v in caches[0].items()}
    cache32["pos"].fill_(C // 2)
    with torch.inference_mode():
        lr_pre, _ = T.prefill_full(p32, c32, {"tokens": toks}, impl="plain")
        lr_dec, _ = T.decode_step(p32, c32, cache32, dtoks, impl="plain")
    del cache32
    hold(torch, "dryrun-card prefill", Lr, logits["prefill", "kernel"],
         logits["prefill", "plain"], lr_pre, cfg.vocab_size)
    hold(torch, "dryrun-card decode", Lr, logits["decode", "kernel"],
         logits["decode", "plain"], lr_dec, cfg.vocab_size)

    # the plain prefill on a one-rank mesh of the card
    mesh = make_host_mesh()
    try:
        dparams = distribute_params(params, cfg, mesh)
        with torch.inference_mode(), use_mesh(mesh):
            dt = distribute_tensor(toks, mesh,
                                   placements_for(toks.shape, "dp", None))
            lm, _ = T.prefill_full(dparams, cfg, {"tokens": dt},
                                   impl="plain")
            lm = lm.full_tensor()
    finally:
        dist.destroy_process_group()
    equal = torch.equal(lm, logits["prefill", "plain"])
    log(f"# dryrun card mesh {tuple(mesh.mesh.shape)} "
        f"({mesh.device_type}): plain prefill logits bit-equal to no "
        f"mesh: {equal}")
    if not equal:
        fail("phase 34: the one-rank mesh's prefill differs from no mesh's")


def main() -> None:
    # growable segments: llava's phase runs its float32 reference within
    # 6 GiB of the card's 79 GiB beside 64 GiB of bf16 weights, where
    # the fixed-size segments of earlier phases would leave fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.launch import serve
    from repro_torch.models import moe

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

    def time_flash(S, H=16, Hkv=2, dh=128, window=0, rng=gen):
        flops, nbytes = flash_work(1, S, S, H, Hkv, 0, dh, window)
        cases = [flash_case(torch, rng, 1, S, S, H, Hkv, dev, dh)
                 for _ in range(copies(nbytes))]
        lib_cases = [tuple(x.transpose(1, 2) for x in c) for c in cases]
        kernel = functools.partial(fl_ops.flash_attention, window=window)
        plain = functools.partial(flash_attention_ref, window=window)
        # SDPA takes a window only as an explicit mask (a yardstick only)
        i = torch.arange(S, device=dev)
        banded = 0 < window < S
        band = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
                if banded else None)

        def sdpa(q, k, v):
            if banded:
                return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        res = {
            "ms": timer(kernel, cases),
            "device_ms": timer.device(kernel, cases),
            "plain_ms": timer(plain, cases, runs=3),
            "library_ms": timer(sdpa, lib_cases),
            "library_device_ms": timer.device(sdpa, lib_cases),
        }
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
        log(f"# flash time S={S} H={H} Hkv={Hkv} dh={dh} window={window} "
            f"({len(cases)} input sets): " + json.dumps(res))
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

    def time_paged(lengths, nb=None, H=16, Hkv=2, dh=128, rng=gen):
        first = paged_case(torch, rng, lengths, 8, H, Hkv, dev, nb, dh)
        nbytes = 2 * first[1].numel() * first[1].element_size()  # K, V
        cases = [first] + [paged_case(torch, rng, lengths, 8, H, Hkv, dev,
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
    def time_chunk(Sq, off, H=16, Hkv=2, dh=128, rng=gen):
        """Flash at Sq query rows after ``off`` cached ones (a prefill
        chunk, a verify pass): held against its plain version, then timed
        beside it, SDPA given the causal offset as a mask, and its bound."""
        Skv = off + Sq
        q, k, v = flash_case(torch, rng, 1, Sq, Skv, H, Hkv, dev, dh)
        out = fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
        err = (out.float() - ref.float()).abs().max().item()
        if not math.isfinite(err) or err > KERNEL_ATOL:
            fail(f"flash at Sq={Sq} q_offset={off} H={H} Hkv={Hkv} dh={dh} "
                 f"disagrees: {err}")
        flops, nbytes = flash_work(1, Sq, Skv, H, Hkv, off, dh)
        cases = [flash_case(torch, rng, 1, Sq, Skv, H, Hkv, dev, dh)
                 for _ in range(copies(nbytes))]
        mask = (torch.arange(Skv, device=dev)[None, :]
                <= off + torch.arange(Sq, device=dev)[:, None])
        lib_cases = [tuple(x.transpose(1, 2) for x in c) for c in cases]

        def kernel(q, k, v):
            return fl_ops.flash_attention(q, k, v, causal=True, q_offset=off)

        def sdpa(q, k, v):
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
        log(f"# flash chunk time H={H} Hkv={Hkv} dh={dh}: " + json.dumps(res))
        return res

    t0 = time.perf_counter()
    chunk_rows = [time_chunk(Sq, off) for Sq, off in [(16, 48), (16, 448),
                                                     (64, 48), (64, 448)]]
    fl_err = max([fl_err] + [r["max_abs_err"] for r in chunk_rows])
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

    def time_dense(lengths, Smax, H=16, Hkv=2, dh=128, rng=gen):
        B = len(lengths)
        first = dense_case(torch, rng, lengths, Smax, H, Hkv, dev, dh)
        nbytes = 2 * first[1].numel() * first[1].element_size()
        cases = [first] + [dense_case(torch, rng, lengths, Smax, H, Hkv, dev,
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
    errs = attention_at_heads(
        torch, dev, gen, fl_ops, dec_ops, flash_attention_ref, HEADS_GRANITE,
        64, [(1, 512, 512, 0), (1, 509, 509, 0), (2, 70, 300, 230),
             (2, 96, 96, 0), (1, 1, 449, 448), (1, 16, 464, 448),
             (1, 64, 112, 48), (1, 64, 576, 512)],
        [(lengths_mixed, None), ([1, 32, 33, 63, 97, 544, 584, 9], 73)],
        "dh 64")
    errs["dense"] = 0.0
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

    # 3f') the selective scan (kernel 5), from a generator of its own
    t0 = time.perf_counter()
    gen_scan = torch.Generator(device=dev)
    gen_scan.manual_seed(30)
    scan_err, rows["scan"] = scan_phase(torch, dev, gen_scan, timer)
    log(f"# phase kernels (scan): {time.perf_counter() - t0:.1f} s")

    # 3f'') the MoE FFN at the jamba and granite cells' shapes, grouped
    #       against padded, from a generator of its own
    t0 = time.perf_counter()
    gen_moe = torch.Generator(device=dev)
    gen_moe.manual_seed(33)
    moe_phase(torch, dev, gen_moe, timer)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"# phase moe: {time.perf_counter() - t0:.1f} s")

    # 3g) hymba-1.5b's heads (25/5 of 64, G = 5): flash without and with
    #     its window of 1024, dense decode over its 1024-row ring
    #     (from a generator of its own, and timed from it: a phase added
    #     here leaves the inputs of every later phase as they were)
    t0 = time.perf_counter()
    gen_3g = torch.Generator(device=dev)
    gen_3g.manual_seed(20)
    errs = hymba_kernels(torch, dev, gen_3g, fl_ops, dec_ops,
                         flash_attention_ref, decode_attention_ref)
    H, Hkv = HEADS_HYMBA
    # the serve's own call: S = 512 with the window, launched unbanded
    rows["flash"]["hymba"] = {
        "max_abs_err": errs["flash"],
        **time_flash(512, H, Hkv, 64, HYMBA_WINDOW, rng=gen_3g)}
    rows["flash"]["hymba_window"] = {
        "window": HYMBA_WINDOW,
        **time_flash(2048, H, Hkv, 64, HYMBA_WINDOW, rng=gen_3g)}
    rows["dense"]["hymba_ring"] = {
        "max_abs_err": errs["dense"],
        **time_dense([544] * 8, HYMBA_WINDOW, H, Hkv, 64, rng=gen_3g)}
    rows["dense"]["hymba_ring"]["wrapped"] = time_dense(
        [HYMBA_WINDOW] * 8, HYMBA_WINDOW, H, Hkv, 64, rng=gen_3g)
    fl_err, dense_err = max(fl_err, errs["flash"]), max(dense_err,
                                                        errs["dense"])
    log(f"# phase kernels (hymba): {time.perf_counter() - t0:.1f} s")

    # 3h) musicgen-large's heads (32/32 of 64, G = 1) for flash and paged
    #     decode, and the speculative verify pass's shape (flash at 4 query
    #     rows after 512 cached ones, qwen2.5-3b's heads); from a generator
    #     of its own, as 3g
    t0 = time.perf_counter()
    gen_3h = torch.Generator(device=dev)
    gen_3h.manual_seed(21)
    errs = attention_at_heads(
        torch, dev, gen_3h, fl_ops, dec_ops, flash_attention_ref,
        HEADS_MUSICGEN, 64, [(1, 512, 512, 0), (1, 509, 509, 0),
                             (2, 70, 300, 230), (1, 64, 576, 512),
                             (1, 4, 516, 512)],
        [(lengths_mixed, None), ([544] * 8, 73)], "musicgen's heads")
    H, Hkv = HEADS_MUSICGEN
    rows["flash"]["musicgen"] = {
        "max_abs_err": errs["flash"],
        **time_flash(512, H, Hkv, 64, rng=gen_3h)}
    rows["paged"]["musicgen"] = {
        "max_abs_err": errs["paged"],
        **time_paged([544] * 8, nb=73, H=H, Hkv=Hkv, dh=64, rng=gen_3h)}
    rows["flash"]["verify"] = time_chunk(SPEC_K, 512, rng=gen_3h)
    fl_err = max(fl_err, errs["flash"], rows["flash"]["verify"]["max_abs_err"])
    dec_err = max(dec_err, errs["paged"])
    log(f"# phase kernels (musicgen, verify): "
        f"{time.perf_counter() - t0:.1f} s")

    # 3i) llava-next-34b's heads (56/8 of 128, G = 7) for flash at the
    #     text prompt (S = 512) and the vision prompt (S = 3,392), and
    #     paged decode at the serve's step; from a generator of its own
    t0 = time.perf_counter()
    gen_3i = torch.Generator(device=dev)
    gen_3i.manual_seed(22)
    S_vis = 2880 + LLAVA_TEXT
    errs = attention_at_heads(
        torch, dev, gen_3i, fl_ops, dec_ops, flash_attention_ref,
        HEADS_LLAVA, 128, [(1, 512, 512, 0), (1, S_vis, S_vis, 0),
                           (1, 509, 509, 0), (2, 70, 300, 230),
                           (1, 64, 576, 512)],
        [(lengths_mixed, None), ([544] * 8, 73), ([544] * 8, 128)],
        "llava's heads")
    H, Hkv = HEADS_LLAVA
    rows["flash"]["llava"] = {"max_abs_err": errs["flash"],
                              **time_flash(512, H, Hkv, rng=gen_3i)}
    rows["flash"]["llava_vision"] = time_flash(S_vis, H, Hkv, rng=gen_3i)
    rows["paged"]["llava"] = {
        "max_abs_err": errs["paged"],
        **time_paged([544] * 8, nb=73, H=H, Hkv=Hkv, rng=gen_3i)}
    fl_err, dec_err = max(fl_err, errs["flash"]), max(dec_err, errs["paged"])
    log(f"# phase kernels (llava): {time.perf_counter() - t0:.1f} s")

    # 4) model: full-width qwen2.5-3b, kernel path vs plain path vs fp32
    cfg = get_config("qwen2.5-3b")
    weights = {"qwen": model_phase(torch, cfg, dev, gen)}
    torch.cuda.empty_cache()

    counters = {"flash": fl_ops.flash_attention,
                "paged": dec_ops.decode_attention_paged,
                "dense": dec_ops.decode_attention,
                "wkv": wkv_ops.wkv,
                "scan": scan_ops.selective_scan}
    by_path, grouped_by_path = {}, {}

    def drive(path, fn):
        """Run one path with every launch count and the MoE's grouped calls
        set to 0 just before it and read just after; returns (its result,
        its launch counts). What an earlier path left in reference cycles
        (its engines, its weights) is collected first, so the peak memory
        printed is this path's. No path prefills a long MoE prompt, so a
        grouped call fails it."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        moe.grouped_calls = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        n = {name: c.launches for name, c in counters.items()}
        by_path[path] = n
        grouped_by_path[path] = moe.grouped_calls
        log(f"# phase {path}: {time.perf_counter() - t0:.1f} s wall, "
            f"launches {n}, moe grouped calls {moe.grouped_calls}, "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if moe.grouped_calls:
            fail(f"{path}: {moe.grouped_calls} MoE calls took the grouped "
                 "dispatch, where no prompt is long enough")
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
    dense_rec = rec
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
    paged_serve(serve, drive, sla, get_config, GRANITE, "serve-granite",
                24 * 2**20)
    log(f"# phase granite serve: {time.perf_counter() - t0:.1f} s")

    # 20) granite profile: a decode step of 8 slots and a 512-token
    #     prefill, with the MoE FFN's share of the device time
    t0 = time.perf_counter()
    profile_phase(torch, get_config(GRANITE), dev)
    log(f"# phase granite profile: {time.perf_counter() - t0:.1f} s")

    # 21) hymba-1.5b: full width and depth, a 1,100-token prompt past the
    #     window and 8 decode steps with the ring wrapped, three ways
    hymba = get_config(HYMBA)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = hymba_model_phase(torch, hymba, dev, gen)
    torch.cuda.synchronize()
    log(f"# phase hymba model ({hymba.num_layers} layers, "
        f"{hymba.num_heads}/{hymba.num_kv_heads} heads of {hymba.dh}, window "
        f"{hymba.sliding_window}, SSM state {hymba.ssm_state}, "
        f"{n_params(params) / 1e9:.3f} B parameters): "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()

    # 22) hymba served disaggregated: phase 5's traffic, the ring and the
    #     SSM state handed over
    t0 = time.perf_counter()
    hymba_serve(serve, drive, sla, get_config)
    log(f"# phase hymba serve: {time.perf_counter() - t0:.1f} s")

    # 23) hymba profile: a decode step of 8 slots and a 512-token prefill,
    #     with the SSM branch's share of the device time
    t0 = time.perf_counter()
    profile_phase(torch, hymba, dev)
    log(f"# phase hymba profile: {time.perf_counter() - t0:.1f} s")

    # 24) musicgen-large: full width and depth (G = 1, dh 64), three ways
    t0 = time.perf_counter()
    musicgen_model_phase(torch, dev, gen, get_config)
    log(f"# phase musicgen model: {time.perf_counter() - t0:.1f} s")

    # 25) musicgen served disaggregated: phase 5's traffic, 192 MiB handoffs
    t0 = time.perf_counter()
    paged_serve(serve, drive, sla, get_config, MUSICGEN, "serve-musicgen",
                201_326_592)
    log(f"# phase musicgen serve: {time.perf_counter() - t0:.1f} s")

    # 26) kv-quant: qwen2.5-3b's int8 cache, three ways
    t0 = time.perf_counter()
    kvquant_model_phase(torch, dev, gen, get_config)
    log(f"# phase kv-quant model: {time.perf_counter() - t0:.1f} s")

    # 27) kv-quant served: phase 8's dense serve, 130/256 of its handoff
    t0 = time.perf_counter()
    kvquant_serve(torch, drive, sla, get_config, dev, dense_rec)
    log(f"# phase kv-quant serve: {time.perf_counter() - t0:.1f} s")

    # 28) speculative decoding: a 4-layer draft of qwen2.5-3b, k = 4
    t0 = time.perf_counter()
    speculative_phase(torch, dev, drive, get_config)
    log(f"# phase speculative: {time.perf_counter() - t0:.1f} s")

    # 29) llava-next-34b: full width and depth, a vision prompt of 3,392
    #     positions, three ways
    t0 = time.perf_counter()
    llava_model_phase(torch, dev, get_config)
    log(f"# phase llava model: {time.perf_counter() - t0:.1f} s")

    # 30) llava served disaggregated: phase 5's traffic (text prompts),
    #     120 MiB handoffs
    t0 = time.perf_counter()
    paged_serve(serve, drive, sla, get_config, LLAVA, "serve-llava",
                LLAVA_HANDOFF)
    log(f"# phase llava serve: {time.perf_counter() - t0:.1f} s")

    # 31) training at full width: qwen2.5-3b at full depth, 4-layer checks
    t0 = time.perf_counter()
    train_phase(torch, dev, drive, get_config)
    log(f"# phase train: {time.perf_counter() - t0:.1f} s")

    # 32) the training launcher and the checkpoint: crash, resume, fresh
    t0 = time.perf_counter()
    train_launcher_phase(torch, dev, drive, get_config)
    log(f"# phase train launcher: {time.perf_counter() - t0:.1f} s")

    # 33) the dry run on this host: one serve cell per family, 16x16 mesh
    t0 = time.perf_counter()
    dryrun_host_phase()
    log(f"# phase dryrun host: {time.perf_counter() - t0:.1f} s")

    # 34) the dry run's per-device prediction against the card
    t0 = time.perf_counter()
    dryrun_card_phase(torch, dev, drive, get_config)
    log(f"# phase dryrun card: {time.perf_counter() - t0:.1f} s")

    # 35) the static analysis on this host (no kernel, no card)
    t0 = time.perf_counter()
    analysis_phase(smi)
    log(f"# phase analysis: {time.perf_counter() - t0:.1f} s")

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
        {"name": "selective_scan", "route": "cuda",
         "source": source.format("selective_scan", "selective_scan"),
         "replaces": None,      # the JAX package's scan is XLA's
         "launches": total("scan"), "max_row_err": scan_err, **rows["scan"]},
    ]
    for k, key in zip(kernels, ("flash", "paged", "dense", "wkv", "scan")):
        k["launches_by_path"] = {path: n[key] for path, n in by_path.items()}
    log("# moe grouped calls by path: " + json.dumps(grouped_by_path))
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
