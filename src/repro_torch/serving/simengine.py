"""Analytic-time simulation backend: an ``Engine`` twin clocked by rooflines.

The port's copy of ``repro.serving.simengine``. ``SimEngine`` mirrors the
torch engine's surface — ``prefill`` / ``prefill_chunked`` / ``insert`` /
``decode_step`` plus the health, hardware, and telemetry attributes the
``Cluster`` loop and its policies consume — but every step is O(1) token
bookkeeping: no params, no tensors, no card. Step durations come from
``core/perf_model.py`` rooflines evaluated on the engine's ``ChipConfig``
(so a faster chip's sim engine is faster for exactly the modelled
reasons), optionally rescaled by a ``SimCalibration`` fitted against a
short run of the port's torch ``Engine`` (``calibrate()``), so simulated
FTL/TTL land in the measured regime. Fitted on the card with the ``h100``
chip, the simulator's clock becomes the H100's.

Why it exists: the torch backend tops out at real-compute speed —
``Cluster.serve`` advances its virtual clock with measured step times —
which caps the executable simulator at a few requests per second. On this
backend the same event loop, schedulers, routers, rate matchers, prefix
caches, and failure injection run unchanged, orders of magnitude faster,
which is what sweeping many design points needs.

Token streams are deterministic: each request carries a counting rng
seeded from its prompt (O(1) — length + endpoint tokens), so replays,
requeues after failure injection, and cross-backend schedule-parity checks
all see identical token ids regardless of engine placement. Every
function but ``calibrate`` is the reference's, number for number: the two
packages' simulators give the same schedules and streams.

This module is numpy-only (no torch): ``calibrate()`` is the one function
that touches the torch backend, and imports it lazily. Where it differs
from the reference's: it builds the port's ``Engine`` on ``device``
(default ``cuda``, raising with no card, like every entry point of the
port), so on the card the fit times the hand-written kernels' path; and it
records the measured and predicted seconds and the step counts beside the
scales in the persisted table.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hardware import (ChipConfig, DEFAULT_SYSTEM,
                                       SystemConfig, as_system,
                                       relative_speed)
from repro_torch.core.paper_models import perf_llm_from_config
from repro_torch.core.perf_model import (Mapping, OP_LATENCY, PerfLLM,
                                         _compute_time,
                                         _weight_bytes_per_chip,
                                         decode_step_perf, kv_shard_chips,
                                         prefill_perf)
from repro_torch.serving.common import EngineFailure, PrefixCache, StepLog

# counting-rng stride (Knuth's multiplicative hash constant): consecutive
# token ids decorrelate without any per-token state beyond the counter
_TOK_STRIDE = 2654435761


def _token_base(prompt: np.ndarray) -> int:
    """O(1) per-request seed: prompt length + endpoint tokens. Depends only
    on the request, not the engine — requeues and backend swaps replay the
    identical stream."""
    n = len(prompt)
    a = int(prompt[0]) if n else 0
    b = int(prompt[-1]) if n else 0
    return (1000003 * n + 8191 * a + 127 * b) & 0x7FFFFFFF


@dataclasses.dataclass
class SimCache:
    """The KV-handoff payload, reduced to bookkeeping: resident length,
    transfer size (precomputed — ``cluster.kv_bytes`` reads ``nbytes``
    instead of walking tensors), and the request's token-stream seed."""
    length: int
    nbytes: int
    token_base: int


@dataclasses.dataclass(frozen=True)
class SimCalibration:
    """Per-(model, chip) scale from roofline seconds to measured seconds.

    The roofline is napkin-grade on purpose (datasheet peaks, modelled
    efficiencies); a short real run anchors its absolute scale so simulated
    latencies are comparable to measured ones. 1.0 = trust the roofline."""
    prefill_scale: float = 1.0
    decode_scale: float = 1.0

    def key(self) -> str:       # pragma: no cover - debugging nicety
        return f"p{self.prefill_scale:.3g}/d{self.decode_scale:.3g}"


# ---------------------------------------------------------------------------
# shared roofline memo tables + vectorized grid fill
#
# Every SimEngine with the same (PerfLLM, SystemConfig, Mapping) — all
# frozen, hashable dataclasses — sees the same roofline, so their memo
# tables are shared process-wide: a homogeneous 1k-engine fleet evaluates
# each distinct (batch, kv) decode point once total. Tables store RAW
# roofline seconds; per-engine calibration and speed factors are applied
# after lookup.

_GROUP_TABLES: Dict[Tuple[PerfLLM, SystemConfig, Mapping],
                    Tuple[Dict[int, float], Dict[Tuple[int, int], float]]] \
    = {}


def _group_tables(perf: PerfLLM, sys_: SystemConfig, map_: Mapping
                  ) -> Tuple[Dict[int, float], Dict[Tuple[int, int], float]]:
    key = (perf, sys_, map_)
    tabs = _GROUP_TABLES.get(key)
    if tabs is None:
        tabs = ({}, {})         # (prefill memo, decode memo)
        _GROUP_TABLES[key] = tabs
    return tabs


def decode_grid(model: PerfLLM, m: Mapping, batch: int,
                kv_lens: np.ndarray, sys_=None) -> np.ndarray:
    """Vectorized twin of ``decode_step_perf(...).step_s`` over many kv
    lengths at one batch size: one NumPy pass instead of one scalar
    roofline call per point.

    Only the attention-flops and KV-bytes terms depend on kv; they are
    broadcast here in the scalar code's exact operation order (float64
    throughout), and every kv-independent term comes from the *same*
    helpers the scalar path calls — so each grid entry is bit-identical to
    ``decode_step_perf`` and priming the shared memo cannot perturb a
    schedule (asserted by ``tests/test_fleet_scale.py``)."""
    if sys_ is None:
        sys_ = DEFAULT_SYSTEM
    kv = np.asarray(kv_lens, dtype=np.float64)
    b = batch
    if model.attention == "none":
        # rwkv: O(1) state update, kv-independent
        attn_flops = (4.0 * model.num_layers * model.d_model * model.dh
                      ) * b + 0.0 * kv
    else:
        span = kv
        if model.sliding_window:
            span = np.minimum(kv, float(model.sliding_window))
        if model.attention == "mla":
            rank = model.mla_kv_rank + model.mla_rope_dim
            attn_flops = (4.0 * model.num_layers * model.num_heads * rank
                          * span) * b
        else:
            attn_flops = (4.0 * model.num_layers * model.num_heads
                          * model.dh * span) * b

    w_bytes = _weight_bytes_per_chip(model, m, b)
    kv_total_bytes = b * kv * model.kv_bytes_per_token()
    kv_bytes = kv_total_bytes / kv_shard_chips(model, m)
    act_bytes = (8.0 * b * model.d_model * model.bytes_act
                 * model.num_layers / (m.tp * m.pp))
    mem_bytes = w_bytes + kv_bytes + act_bytes

    compute_s = _compute_time(model, m, b, b, attn_flops, sys_)
    memory_s = mem_bytes / sys_.chip.hbm_bw

    coll_bytes = 0.0
    n_ops = 0
    b_local = b / m.dp_attn
    if m.tp > 1:
        coll_bytes += (2 * model.num_layers * 2.0 * b_local * model.d_model
                       * model.bytes_act * (m.tp - 1) / m.tp)
        n_ops += 2 * model.num_layers
    if model.is_moe and m.ep > 1:
        coll_bytes += (2 * model.num_layers * (b * model.top_k / m.ep)
                       * model.d_model * model.bytes_act * (m.ep - 1) / m.ep)
        n_ops += 2 * model.num_layers
    if m.pp > 1:
        coll_bytes += ((m.pp - 1) * b_local * model.d_model
                       * model.bytes_act / m.pp)
        n_ops += m.pp - 1
    collective_s = coll_bytes / sys_.chip.ici_bw + n_ops * OP_LATENCY

    exposed_s = collective_s * (1.0 - sys_.collective_overlap)
    return np.maximum(compute_s, memory_s) + exposed_s


def prime_decode(engines, kv_max: int, *, kv_min: int = 1,
                 batches=None) -> int:
    """Pre-fill the shared decode memo for each homogeneous engine group
    with one vectorized roofline pass per (group, batch size). Serving then
    reduces every decode tick to a dict lookup. Returns the number of grid
    points added; existing entries are never overwritten (they are already
    bit-equal). Safe to call at any time — before, between, or mid-run."""
    by_key: Dict[Tuple[PerfLLM, SystemConfig, Mapping], int] = {}
    for e in engines:
        k = (e._perf, e._sys, e._map)
        if e.slots > by_key.get(k, 0):
            by_key[k] = e.slots
    kv = np.arange(max(kv_min, 1), max(kv_max, kv_min) + 1, dtype=np.int64)
    added = 0
    for (perf, sys_, map_), bmax in by_key.items():
        _pre, dec = _group_tables(perf, sys_, map_)
        for b in (batches if batches is not None else range(1, bmax + 1)):
            grid = decode_grid(perf, map_, max(int(b), 1), kv, sys_)
            for kv_len, t in zip(kv.tolist(), grid.tolist()):
                key = (b, kv_len)
                if key not in dec:
                    dec[key] = t
                    added += 1
    return added


class SimEngine:
    """Drop-in ``Engine`` twin: O(1) bookkeeping steps on a roofline clock.

    Accepts either an executable ``ModelConfig`` (bridged through
    ``perf_llm_from_config``) or a ``core.perf_model.PerfLLM`` directly —
    the latter lets sweeps simulate the paper's study models (deepseek-r1,
    llama-3.1-*) that have no executable config. ``params`` is accepted and
    ignored so construction sites are backend-agnostic."""

    backend = "sim"

    def __init__(self, engine_id: int, cfg, params=None,
                 *, slots: int = 8, capacity: int = 256,
                 chunk_size: int = 0, chip: Optional[ChipConfig] = None,
                 speed_factor: Optional[float] = None,
                 calibration: Optional[SimCalibration] = None,
                 step_history: int = 0, block_size: int = 0):
        self.engine_id = engine_id
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.capacity = capacity
        self.chunk_size = chunk_size
        self.healthy = True
        self.clock = 0.0
        # step_history=0 keeps every step time (list semantics, the
        # default); N keeps the last N..2N with absolute indices intact —
        # fleet-scale runs opt in so memory stays flat over 1e6+ steps
        self.step_times = StepLog(step_history)
        self._slow_factor = 1.0
        self.chip = chip
        self.hardware = chip.name if chip is not None else "uniform"
        default_sf = (1.0 / relative_speed(chip)
                      if chip is not None else 1.0)
        self.speed_factor = (speed_factor if speed_factor is not None
                             else default_sf)
        # the roofline already runs on the engine's own chip, so only an
        # *explicit* speed_factor override scales times (relative to the
        # chip's natural speed — mirrors Engine's measured-time semantics)
        self._extra = self.speed_factor / default_sf
        self.calibration = calibration or SimCalibration()

        if isinstance(cfg, PerfLLM):
            self._perf = cfg
            attn_like = cfg.attention in ("gqa", "mla")
        else:                       # executable ModelConfig (duck-typed —
            self._perf = perf_llm_from_config(cfg)   # no torch import here)
            attn_like = cfg.block == "attn"
        # block_size > 0 mirrors the real backend's *paged* KV layout:
        # handoff payloads are sized by block-rounded true length (not slot
        # capacity) and the decode roofline reads block-rounded context.
        # 0 (default) mirrors the dense layout: capacity-sized payloads,
        # exact mean context.
        self.block_size = (block_size if attn_like
                           and self._perf.kv_bytes_per_token() > 0 else 0)
        self.vocab = int(self._perf.vocab_size)
        self._sys: SystemConfig = (as_system(chip) if chip is not None
                                   else DEFAULT_SYSTEM)
        self._map = Mapping(chips=1)
        self.prefix_cache = (PrefixCache(chunk_size)
                             if chunk_size and attn_like else None)
        self.cache = None           # no decode tensors on this backend
        self._free: List[int] = list(range(slots))
        self.slot_req: Dict[int, Any] = {}
        self._slot_pos: Dict[int, int] = {}     # slot -> kv tokens resident
        self._slot_tok: Dict[int, Tuple[int, int]] = {}  # slot -> (base, i)
        # roofline memo tables are SHARED across every engine with the same
        # (model, system, mapping) roofline — a 1k-engine homogeneous fleet
        # evaluates each distinct (batch, kv) point once, not once per
        # engine. Tables hold RAW roofline seconds; calibration scale and
        # speed factors are applied after lookup, so engines with different
        # calibrations share safely.
        self._prefill_memo, self._decode_memo = _group_tables(
            self._perf, self._sys, self._map)

    # ---- fault/straggler injection hooks (same seams as Engine) ---------

    def fail(self):
        self.healthy = False

    def slow_down(self, factor: float):
        self._slow_factor = factor

    @property
    def capacity_weight(self) -> float:
        return 1.0 / self.speed_factor

    def describe(self) -> Dict[str, Any]:
        """Static metadata for trace track labels (serving.tracing)."""
        return {"engine_id": self.engine_id, "backend": self.backend,
                "hardware": self.hardware, "slots": self.slots,
                "capacity": self.capacity, "paged": self.block_size > 0,
                "block_size": self.block_size,
                "speed_factor": self.speed_factor,
                "capacity_weight": self.capacity_weight}

    def _check(self):
        if not self.healthy:
            raise EngineFailure(f"engine {self.engine_id} is down")

    def _advance(self, dt: float) -> float:
        dt *= self._slow_factor
        self.clock += dt
        self.step_times.append(dt)
        return dt

    # ---- roofline clock --------------------------------------------------

    def _prefill_latency(self, n_tokens: int) -> float:
        """End-to-end roofline latency of prefilling ``n_tokens`` on one
        chip (memoized: requests of one shape cost one evaluation)."""
        t = self._prefill_memo.get(n_tokens)
        if t is None:
            t = prefill_perf(self._perf, self._map, 1, max(n_tokens, 1),
                             self._sys).latency_s
            self._prefill_memo[n_tokens] = t
        return t

    def _prefill_s(self, n_new: int, ctx: int = 0) -> float:
        """Time to prefill ``n_new`` tokens given ``ctx`` already cached
        (prefix reuse): the marginal roofline cost of the suffix."""
        full = self._prefill_latency(ctx + n_new)
        base = self._prefill_latency(ctx) if ctx > 0 else 0.0
        return max(full - base, 0.0) * self.calibration.prefill_scale \
            * self._extra

    def _decode_s(self, batch: int, kv_len: int) -> float:
        key = (batch, kv_len)
        t = self._decode_memo.get(key)
        if t is None:
            t = decode_step_perf(self._perf, self._map, max(batch, 1),
                                 max(kv_len, 1), self._sys).step_s
            self._decode_memo[key] = t
        return t * self.calibration.decode_scale * self._extra

    def _payload_bytes(self, length: Optional[int] = None) -> int:
        """Handoff size of one request's cache. Dense mirror
        (``block_size == 0``): the real backend's B=1 prefill cache is
        allocated at engine ``capacity`` — the transfer ships the padded
        tensors, not just the filled prefix. Paged mirror
        (``block_size > 0``): only the request's own blocks travel, so the
        payload is the *block-rounded true length*. Attention-free models
        ship their O(1) recurrent state either way."""
        bytes_per_tok = self._perf.kv_bytes_per_token()
        if bytes_per_tok > 0:
            if self.block_size and length is not None:
                Bs = self.block_size
                length = -(-length // Bs) * Bs
                return int(length * bytes_per_tok)
            return int(self.capacity * bytes_per_tok)
        p = self._perf                      # rwkv-style state: [H, N, N]
        state = p.num_layers * p.num_heads * p.dh * p.dh * 4
        mixes = 2 * p.num_layers * p.d_model * p.bytes_act
        return int(state + mixes)

    # ---- prefill role ----------------------------------------------------

    def _first_token(self, base: int) -> int:
        return base % self.vocab

    def prefill(self, prompt: np.ndarray) -> Tuple[int, SimCache]:
        """Full prefill of one prompt; returns (first_token, cache)."""
        self._check()
        base = _token_base(prompt)
        self._advance(self._prefill_s(len(prompt)))
        return self._first_token(base), SimCache(
            length=len(prompt), nbytes=self._payload_bytes(len(prompt)),
            token_base=base)

    def prefill_chunked(self, prompt: np.ndarray, chunk: int,
                        on_chunk=None) -> Tuple[int, SimCache]:
        """Chunked prefill resuming from the longest cached prefix; fires
        ``on_chunk`` per chunk exactly like the real engine (piggyback
        policies interleave decode rounds there). The first token matches
        ``prefill`` — both backends derive it from the same stream."""
        self._check()
        S = len(prompt)
        pad = (-S) % chunk
        start = 0
        if self.prefix_cache is not None:
            _cache, start = self.prefix_cache.lookup(prompt)
        base = _token_base(prompt)
        self._advance(self._prefill_s(S - start + pad, ctx=start))
        # paged mirror: the chunked payload ships ceil(S/chunk) chunks of
        # blocks (the real engine pads the prompt to a chunk multiple)
        cache = SimCache(length=S, nbytes=self._payload_bytes(S + pad),
                         token_base=base)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, cache)
        if on_chunk:
            n = (S - start + pad) // chunk
            for i in range(n):
                on_chunk(i, max(n, 1))
        return self._first_token(base), cache

    # ---- decode role -----------------------------------------------------

    def has_free_slot(self) -> bool:
        return bool(self._free)

    @property
    def active(self) -> int:
        return len(self.slot_req)

    def insert(self, req, cache: SimCache) -> int:
        """KV handoff: pure bookkeeping (the modelled transfer cost lives
        in the reference's ``core/kv_transfer.py``, not ported yet; the
        torch backend's scatter is measured, not modelled)."""
        self._check()
        slot = self._free.pop()
        self.slot_req[slot] = req
        self._slot_pos[slot] = cache.length
        # resume the counting stream where the request's output left off
        self._slot_tok[slot] = (cache.token_base, len(req.output))
        req.slot = slot
        req.engine_id = self.engine_id
        return slot

    def evict(self, slot: int):
        req = self.slot_req.pop(slot, None)
        if req is not None:
            req.slot = None
        self._slot_pos.pop(slot, None)
        self._slot_tok.pop(slot, None)
        self._free.append(slot)

    def decode_step(self, tokens_by_slot: Dict[int, int]) -> Dict[int, int]:
        """One token for every active slot. Batch size and mean resident
        context feed the decode roofline; token ids advance each request's
        counting rng."""
        self._check()
        b = len(self.slot_req)
        if self.block_size:
            # paged mirror: each slot reads whole blocks, so the roofline
            # sees per-slot block-rounded context
            Bs = self.block_size
            kv = int(round(sum(-(-self._slot_pos[s] // Bs) * Bs
                               for s in self.slot_req) / max(b, 1)))
        else:
            kv = int(round(sum(self._slot_pos[s] for s in self.slot_req)
                           / max(b, 1)))
        self._advance(self._decode_s(b, kv))
        out = {}
        for s in tokens_by_slot:
            base, i = self._slot_tok[s]
            out[s] = (base + i * _TOK_STRIDE) % self.vocab
            self._slot_tok[s] = (base, i + 1)
            self._slot_pos[s] += 1
        return out

    @property
    def mean_step_s(self) -> float:
        if not self.step_times:
            return 0.0
        return float(np.mean(self.step_times[-50:]))


# ---------------------------------------------------------------------------
# calibration: fit the roofline scale against a short real-engine run


def calibration_key(model_name: str, chip: Optional[ChipConfig]) -> str:
    return f"{model_name}/{chip.name if chip is not None else 'uniform'}"


def load_calibration(path: str, model_name: str,
                     chip: Optional[ChipConfig] = None
                     ) -> Optional[SimCalibration]:
    """Fetch a persisted fit, or None (callers fall back to the raw
    roofline — scale 1.0)."""
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return None
    rec = table.get(calibration_key(model_name, chip))
    if rec is None:
        return None
    return SimCalibration(prefill_scale=float(rec["prefill_scale"]),
                          decode_scale=float(rec["decode_scale"]))


def save_calibration(path: str, model_name: str,
                     chip: Optional[ChipConfig],
                     cal: SimCalibration, meta: Optional[dict] = None
                     ) -> None:
    """Merge one fit into the JSON table at ``path`` (atomic replace)."""
    table: Dict[str, dict] = {}
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        pass
    table[calibration_key(model_name, chip)] = {
        "prefill_scale": cal.prefill_scale,
        "decode_scale": cal.decode_scale, **(meta or {})}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def calibrate(cfg, params=None, *, chip: Optional[ChipConfig] = None,
              isl: int = 48, osl: int = 8, batch: int = 2,
              n_prompts: int = 3, seed: int = 0,
              path: Optional[str] = None, device=None) -> SimCalibration:
    """Fit a per-(model, chip) ``SimCalibration`` from a short real run.

    Runs ``n_prompts + 1`` prefills and ``osl`` batched decode steps on the
    port's torch ``Engine`` on ``device`` (default ``cuda``; the first of
    each is excluded — it may pay the kernels' build or load and the
    libraries' first-call costs), predicts the same steps with the
    roofline, and returns measured/predicted scales. Each timed step ends
    in ``torch.cuda.synchronize`` (``Engine._tick``), so on the card the
    fit reads device time through the kernel path. ``params`` default to
    ``init_torch_params(cfg, seed, device=device)``. ``path`` persists the
    fit for later sessions (``load_calibration``), with the measured and
    predicted seconds and the step counts beside it. This is the one
    sim-path function that imports torch."""
    from repro_torch.serving.backends import init_torch_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    if params is None:
        params = init_torch_params(cfg, seed, device=device)
    capacity = isl + osl + 8
    eng = Engine(0, cfg, params, slots=max(batch, 1), capacity=capacity,
                 chip=chip, device=device)
    sim = SimEngine(1, cfg, slots=max(batch, 1), capacity=capacity,
                    chip=chip)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, sim.vocab, isl).astype(np.int32)
               for _ in range(n_prompts + 1)]
    caches = []
    for p in prompts:
        _tok, cache = eng.prefill(p)
        caches.append(cache)
    measured_p = float(np.mean(eng.step_times[1:]))     # [0] = first call
    predicted_p = sim._prefill_latency(isl)

    n0 = len(eng.step_times)
    for i, cache in enumerate(caches[:batch]):
        eng.insert(Request(rid=i, prompt=prompts[i], osl=osl), cache)
    toks = {s: 1 for s in eng.slot_req}
    for _ in range(osl):
        toks = eng.decode_step(toks)
    dec_steps = eng.step_times[n0:]
    measured_d = float(np.mean(dec_steps[1:] if len(dec_steps) > 1
                               else dec_steps))
    # the measured steps decode with context growing isl -> isl + osl, so
    # predict at the mean resident length (predicting at isl would bias
    # decode_scale high by ~osl/2 extra context per step)
    predicted_d = decode_step_perf(sim._perf, sim._map, max(batch, 1),
                                   isl + osl // 2, sim._sys).step_s

    cal = SimCalibration(
        prefill_scale=measured_p / max(predicted_p, 1e-12),
        decode_scale=measured_d / max(predicted_d, 1e-12))
    if path is not None:
        save_calibration(path, getattr(cfg, "name", "model"), chip, cal,
                         meta={"isl": isl, "osl": osl, "batch": batch,
                               "n_prompts": n_prompts,
                               "device": str(eng.device),
                               "measured_prefill_s": measured_p,
                               "predicted_prefill_s": predicted_p,
                               "measured_decode_s": measured_d,
                               "predicted_decode_s": predicted_d,
                               "prefills": eng.prefills,
                               "decode_steps": eng.decode_steps})
    return cal
