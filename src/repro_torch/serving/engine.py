"""Executable serving engine on PyTorch: prefill and decode on the card.

One ``Engine`` = one model instance (shared params + step functions)
playing a *role* (prefill / decode / mixed); engines are role-reassignable
at runtime, so elastic scaling is a pool-list operation. It has the
surface ``Cluster`` drives: ``prefill``, ``prefill_chunked``, ``insert``,
``evict``, ``decode_step``, ``has_free_slot``, ``active``, ``fail``,
``slow_down``, ``capacity_weight``, ``describe``, ``step_times``,
``slot_req``, ``prefix_cache``, ``paged`` and ``mean_step_s``.

Decode batches continuously over fixed slots. Two KV layouts share that
surface, as in ``repro.serving.engine``; which one an engine takes, and
whether it chunks prompts, is its model's (``transformer.supports_paged``,
``supports_chunked``):

- **paged** (the default where the model supports it): KV lives in a
  block pool ``[num_blocks, block_size, Hkvp, dh]`` shared by the
  attending layers and the slots, addressed through per-layer block tables
  (the host-side refcounts are ``serving/blocks.py``). ``insert`` scatters
  only the request's blocks, ``evict`` is an O(1) refcount decrement per
  block, decode attends over a pow2-bucketed window that tracks the
  active context, and the prefix cache shares blocks between entries by
  refcount, never by copy. A state the model keeps per slot (a jamba
  model's ``ssm_h``/``conv``, ``transformer.init_slot_state``) sits
  beside the pool, allocated once: the handoff carries it with the
  prompt's blocks, ``insert`` copies it into the slot's rows, and
  eviction leaves them for the next insert to overwrite. Such a model's
  prompts run whole: no chunked prefill, no prefix cache.
- **dense** (``paged=False``, and always where the model has no paged
  layout: RWKV-6, the hybrid family, kv-quant): one ``[slots,
  capacity]``-wide cache of what the model keeps per layer and slot
  (``transformer.init_cache``), with per-slot positions: int8 K/V with
  bf16 scales under kv-quant ((1 + 2/dh) bytes per element against bf16's
  2), RWKV-6's recurrent state (O(1) per request), a windowed hybrid
  model's W-row ring and SSM state (O(W)), whatever the prompt.

``prefill_chunked`` runs the prompt in chunks (the co-located piggyback
path) and, where the model takes chunked prefill and the engine was built
with ``chunk_size``, consults and fills a ``PrefixCache``; the model
refuses any other prompt in chunks, as the reference asserts.
As in the reference, a prompt is padded with token 0 to whole chunks, and
the padded prompt is what the model sees: the first token is read at its
last position, and decoding continues after the pad.

On a CUDA device every prefill (whole or chunked) runs the hand-written
flash-attention kernel, every paged decode step the paged decode kernel
and every dense decode step the dense decode kernel (``impl="kernel"``),
a hybrid model's banded prefill the flash kernel with its window and its
decode step the dense decode kernel over the ring; an RWKV-6 prefill and
decode step run the WKV kernel in every layer;
on the CPU the same calls run their plain PyTorch versions. The kernels
are built when the engine is made, never inside a timed step.

Time: an engine built with a ``ChipConfig`` scales its measured step wall
times by ``1 / relative_speed(chip, GPU_H100)``. The reference chip is the
card the port runs on, so an ``h100`` engine's virtual clock reads measured
H100 time unscaled (the JAX engine's reference chip is ``TPU_V5E``). Every
timed window ends in ``torch.cuda.synchronize()``, so the clock measures
the step and not its enqueue.

Under a ``torch.profiler`` session each step and its phases are spans on
the profiler's clock (``serving.tracing.span``): ``repro_torch.engine.
prefill`` (``.payload``, ``.readback``), ``.insert`` and ``.decode``
(``.prepare``: the paged block growth, window and uploads; ``.readback``:
the argmax, its copy to the host and the closing synchronise, where the
host waits on the device), around the model's own spans.

On a CUDA device a paged decode step is one replay of a CUDA graph of the
whole step (``serving/graphs.py``), one graph per window ``nb``: at most
log2 of the block table's width plus one per engine, each captured on the
first step that meets its window. The step's tables, positions and tokens
are staged in one pinned host buffer and go to the card in one copy, into
a device buffer whose views are the graphs' inputs. The replay is the span
``repro_torch.engine.decode.replay``; ``graph_captures`` and
``graph_replays`` count both (``describe()`` reports them). A capture is a
one-off cost of its window, kept off the step's measured time as the
warm-up is: otherwise the straggler detector would drain an engine for
the windows it meets first. Prefill, the dense layout and the CPU stay
eager.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import GPU_H100, ChipConfig, relative_speed
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.blocks import BlockAllocator, BlockPoolExhausted
from repro_torch.serving.common import EngineFailure, PrefixCache, StepLog
from repro_torch.serving.graphs import DecodeGraphs
from repro_torch.serving.tracing import span


class PagedCache:
    """Paged KV-handoff payload: the request's own blocks, free-floating
    (gathered off the source pool), and a jamba model's SSM state after
    the prompt. ``nbytes`` is the actual transfer size — block-rounded true
    length, not the slot capacity, and the state — which is what
    ``cluster.kv_bytes`` reads."""

    __slots__ = ("blocks", "length", "state")

    def __init__(self, blocks: Dict[str, torch.Tensor], length: int,
                 state: Optional[Dict[str, torch.Tensor]] = None):
        self.blocks = blocks            # {"k","v": [L, nb, Bs, Hkvp, dh]}
        self.length = int(length)
        self.state = state or {}        # {"ssm_h": [Lm, di, ds], "conv"}

    @property
    def nbytes(self) -> int:
        bk = self.blocks["k"]
        return 2 * bk.numel() * bk.element_size() + sum(
            t.numel() * t.element_size() for t in self.state.values())


class PrefixBlocks:
    """A prefix-cache entry's claim on pool blocks: per-layer block ids
    [L, nb] covering ``length`` block-aligned tokens. The entry holds one
    refcount per block; sharing with other entries or in-flight requests
    is a refcount bump, never a copy."""

    __slots__ = ("ids", "length")

    def __init__(self, ids: np.ndarray, length: int):
        self.ids = ids
        self.length = int(length)


def window_blocks(max_pos: int, block_size: int, nb_max: int) -> int:
    """The paged decode step's window in blocks: the least power of two
    whose blocks hold position ``max_pos``, at most ``nb_max``. It is the
    shape the step's tables take, and so the key of its CUDA graph."""
    nb = 1
    while nb * block_size <= max_pos:
        nb *= 2
    return min(nb, nb_max)


def _grow_cache(cache, capacity: int):
    """A trimmed dense prefix entry zero-padded back to ``capacity``. Always
    a fresh tensor: the resumed chunked prefill writes into it in place,
    and the stored entry must stay as it is."""
    out = dict(cache)
    for kk in ("k", "v"):
        c = cache[kk]
        grown = c.new_zeros(c.shape[:2] + (capacity,) + c.shape[3:])
        grown[:, :, :c.shape[2]] = c
        out[kk] = grown
    return out


class Engine:
    """One model instance. Thread-unsafe by design (driven by Cluster)."""

    backend = "torch"

    def __init__(self, engine_id: int, cfg: ModelConfig, params,
                 *, slots: int = 8, capacity: int = 256,
                 chunk_size: int = 0, chip: Optional[ChipConfig] = None,
                 speed_factor: Optional[float] = None,
                 step_history: int = 1024, block_size: int = 8,
                 paged: Optional[bool] = None,
                 pool_blocks: Optional[int] = None,
                 device: DeviceLike = None):
        why = T.unported(cfg)
        if why is not None:
            raise NotImplementedError(f"{cfg.name}: {why}")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        self.engine_id = engine_id
        self.cfg = cfg
        self.params = params            # shared, never copied, by engines
        self.slots = slots
        self.capacity = capacity
        self.chunk_size = chunk_size
        self.healthy = True
        self.clock = 0.0
        self.step_times = StepLog(step_history)
        self._recent = {"prefill": deque(maxlen=50),
                        "decode": deque(maxlen=50)}
        self._last_kind = "decode"
        self.prefills = 0               # steps and their times by kind
        self.decode_steps = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self._slow_factor = 1.0         # straggler injection (tests)
        self.chip = chip
        self.hardware = chip.name if chip is not None else "uniform"
        if speed_factor is not None:
            self.speed_factor = speed_factor
        else:
            self.speed_factor = (1.0 / relative_speed(chip, GPU_H100)
                                 if chip is not None else 1.0)
        self.impl = "kernel" if self.device.type == "cuda" else "plain"
        if self.impl == "kernel":
            _build.build_all()          # never inside a timed step

        if paged is None:
            self.paged = T.supports_paged(cfg)
        elif paged and not T.supports_paged(cfg):
            raise ValueError(f"{cfg.name}: paged KV unsupported for "
                             f"{cfg.block}/kv_quant={cfg.kv_quant}/"
                             f"sliding_window={cfg.sliding_window}")
        else:
            self.paged = bool(paged)
        self.block_size = block_size
        if chunk_size and self.paged and chunk_size % block_size:
            raise ValueError(f"paged chunked prefill needs chunk_size "
                             f"({chunk_size}) % block_size ({block_size}) "
                             "== 0")
        with_prefix = bool(chunk_size) and T.supports_chunked(cfg)
        if chunk_size and self.paged and not with_prefix:
            raise ValueError(f"{cfg.name}: a {cfg.block} model's prompts run "
                             "whole: no chunked prefill, no prefix cache")
        self._free = list(range(slots))
        self.slot_req: Dict[int, Any] = {}
        self._graphs: Optional[DecodeGraphs] = None
        # the layers whose KV the pool pages
        self._kv_layers = len(cfg.attn_layer_ids)
        if self.paged:
            Lr = self._kv_layers
            self._nb_max = -(-capacity // block_size)
            if pool_blocks is None:
                # full decode occupancy + in-flight prefill + prefix headroom
                pool_blocks = 1 + Lr * self._nb_max * (slots + 4)
            self.pool = T.init_block_pool(cfg, pool_blocks, block_size,
                                          device=self.device)
            state = T.init_slot_state(cfg, slots, device=self.device)
            self.pool.update(state)
            self._state_keys = tuple(state)
            self._alloc = BlockAllocator(pool_blocks)
            self._tables = np.zeros((Lr, slots, self._nb_max), np.int32)
            self._pos = np.zeros((slots,), np.int32)
            # a step's tokens (int64, as two int32 words each), positions
            # and table window, staged on the host and copied at once
            n = 3 * slots + Lr * slots * self._nb_max
            on_card = self.device.type == "cuda"
            self._stage_host = torch.zeros((n,), dtype=torch.int32,
                                           pin_memory=on_card)
            self._stage_dev = (torch.zeros((n,), dtype=torch.int32,
                                           device=self.device)
                               if on_card else self._stage_host)
            if self.impl == "kernel":
                self._graphs = DecodeGraphs(self.device)
            self.cache = None
            self.prefix_cache = (
                PrefixCache(chunk_size, on_evict=self._release_entry)
                if with_prefix else None)
        else:
            self.prefix_cache = (PrefixCache(chunk_size) if with_prefix
                                 else None)
            self.cache = T.init_cache(cfg, slots, capacity,
                                      device=self.device)
        self._warm_up()

    @torch.inference_mode()
    def _warm_up(self):
        """One untimed decode step over the empty batch, so the process's
        first-call costs (lazy initialisation of the step's ops and
        libraries) never land in a timed step. The straggler detector
        compares engines' step times; in one process only the first engine
        to step would pay those costs (the reference's engines each compile
        their own jit, and so each pay their own). Every slot is inactive:
        paged writes land in the trash block, dense writes in rows (or, for
        RWKV or a hybrid model's SSM, the whole state of every slot) that
        ``insert`` overwrites, and
        the dense positions are reset."""
        if self.paged:
            T.decode_step_paged(self.params, self.cfg, self.pool,
                                *self._stage({}, 1), impl=self.impl)
        else:
            T.decode_step(self.params, self.cfg, self.cache,
                          self._step_tokens({}), impl=self.impl)
            self.cache["pos"].zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- fault/straggler injection hooks (used by tests & demos) -------

    def fail(self):
        self.healthy = False

    def slow_down(self, factor: float):
        self._slow_factor = factor

    @property
    def capacity_weight(self) -> float:
        """Serving capacity in reference-chip (H100) equivalents — what the
        elastic rate matcher sums instead of counting engine heads."""
        return 1.0 / self.speed_factor

    def describe(self) -> Dict[str, Any]:
        return {"engine_id": self.engine_id, "backend": self.backend,
                "hardware": self.hardware, "slots": self.slots,
                "capacity": self.capacity, "paged": self.paged,
                "block_size": self.block_size if self.paged else 0,
                "speed_factor": self.speed_factor,
                "capacity_weight": self.capacity_weight,
                "device": str(self.device), "impl": self.impl,
                "graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "ssm_state_bytes": self.ssm_state_bytes}

    @property
    def ssm_state_bytes(self) -> int:
        """A slot's SSM state (``ssm_h`` and ``conv``: a jamba engine's
        beside its block pool, a hybrid engine's in its dense cache; 0
        where the model has none)."""
        held = self.pool if self.paged else self.cache
        return sum(held[k][:, 0].numel() * held[k].element_size()
                   for k in ("ssm_h", "conv") if k in held)

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured of the paged decode step (one a window)."""
        return self._graphs.captures if self._graphs is not None else 0

    @property
    def graph_replays(self) -> int:
        """Paged decode steps run as a graph replay."""
        return self._graphs.replays if self._graphs is not None else 0

    def _capture_s(self) -> float:
        return self._graphs.capture_s if self._graphs is not None else 0.0

    def _tick(self, t0: float, kind: str, untimed: float = 0.0):
        """Close a ``kind`` step ("prefill" or "decode") begun at ``t0``:
        its time, less ``untimed`` seconds of one-off set-up inside it (a
        CUDA graph's capture), goes on the clock and into ``step_times``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = ((time.perf_counter() - t0 - untimed) * self.speed_factor
              * self._slow_factor)
        self.clock += dt
        self.step_times.append(dt)
        self._recent[kind].append(dt)
        self._last_kind = kind
        return dt

    def _check(self):
        if not self.healthy:
            raise EngineFailure(f"engine {self.engine_id} is down")

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64),
                               device=self.device)[None, :]

    # ---- block-pool bookkeeping (paged) --------------------------------

    def _release_entry(self, payload: PrefixBlocks):
        """PrefixCache on_evict: drop the entry's refcounts (a block goes
        back to the free list only when no other entry/request holds it)."""
        self._alloc.free(payload.ids.ravel().tolist())

    def _reserve(self, n: int):
        """Ensure n blocks are allocatable, reclaiming LRU prefix entries
        under pressure (the paged analogue of cache-capacity eviction)."""
        while not self._alloc.can_alloc(n):
            if self.prefix_cache is None or not self.prefix_cache.pop_lru():
                raise BlockPoolExhausted(
                    f"engine {self.engine_id}: need {n} blocks, "
                    f"{self._alloc.num_free} free and no prefix entries "
                    f"left to evict")

    # ---- prefill role ---------------------------------------------------

    def _prefill_payload(self, tokens: torch.Tensor):
        """Full prefill -> (logits, handoff blocks, SSM state). The B=1
        cache is padded to whole blocks and reshaped to [L, nb, Bs, Hkvp,
        dh] (block-padded true length, never the slot capacity); logits
        come before any padding; a jamba model's state after the prompt
        rides beside. The payload stays on the device."""
        logits, cache = T.prefill_full(self.params, self.cfg,
                                       {"tokens": tokens}, impl=self.impl)
        S = tokens.shape[1]
        Bs = self.block_size
        Sb = -(-S // Bs) * Bs
        blocks, state = {}, {}
        with span("repro_torch.engine.prefill.payload"):
            for kk in ("k", "v"):
                row = cache[kk][:, 0]                     # [L, S, Hkvp, dh]
                if Sb > S:
                    row = torch.cat([row, row.new_zeros(
                        (row.shape[0], Sb - S) + tuple(row.shape[2:]))],
                        dim=1)
                blocks[kk] = row.reshape(row.shape[0], Sb // Bs, Bs,
                                         *row.shape[2:])
            for kk in self._state_keys:
                state[kk] = cache[kk][:, 0]
        return logits, blocks, state

    def _first_token(self, logits) -> int:
        with span("repro_torch.engine.prefill.readback"):
            return int(torch.argmax(logits[0, :self.cfg.vocab_size]))

    @torch.inference_mode()
    def prefill(self, prompt: np.ndarray) -> Tuple[int, Any]:
        """Full prefill of one prompt; returns (first_token, payload): a
        ``PagedCache`` (paged) or a B=1 dict cache (dense: capacity-wide
        K/V for the attention family, a W-row ring and the SSM state for a
        windowed hybrid, the state for RWKV)."""
        self._check()
        with span("repro_torch.engine.prefill"):
            t0 = time.perf_counter()
            tokens = self._tokens(prompt)
            if self.paged:
                logits, blocks, state = self._prefill_payload(tokens)
                payload = PagedCache(blocks, len(prompt), state)
            else:
                logits, payload = T.prefill_full(
                    self.params, self.cfg, {"tokens": tokens},
                    capacity=self.capacity, impl=self.impl)
            tok = self._first_token(logits)
            self.prefill_s += self._tick(t0, "prefill")
        self.prefills += 1
        return tok, payload

    @torch.inference_mode()
    def prefill_chunked(self, prompt: np.ndarray, chunk: int,
                        on_chunk=None) -> Tuple[int, Any]:
        """Sarathi-style chunked prefill (the executable piggyback path);
        ``on_chunk(i, n)`` fires once per chunk after the whole prefill has
        been timed, as in the reference, so a co-located engine's decode
        rounds follow the prefill tick on the clock. Reuses the longest
        cached prompt prefix when a PrefixCache is attached. Attention
        family only: the model refuses an RWKV prompt."""
        self._check()
        with span("repro_torch.engine.prefill"):
            if self.paged:
                tok, payload, n_chunks = self._prefill_chunked_paged(prompt,
                                                                     chunk)
            else:
                tok, payload, n_chunks = self._prefill_chunked_dense(prompt,
                                                                     chunk)
        if on_chunk:
            for i in range(n_chunks):
                on_chunk(i, max(n_chunks, 1))
        return tok, payload

    def _padded(self, prompt: np.ndarray, chunk: int) -> np.ndarray:
        toks = np.pad(prompt, (0, (-len(prompt)) % chunk), constant_values=0)
        if len(toks) > self.capacity:
            raise ValueError(f"engine {self.engine_id}: prompt of "
                             f"{len(prompt)} tokens pads to {len(toks)} "
                             f"(chunks of {chunk}), over the capacity "
                             f"{self.capacity}")
        return toks

    def _prefill_chunked_dense(self, prompt, chunk):
        S = len(prompt)
        toks = self._padded(prompt, chunk)
        start, base = 0, None
        if self.prefix_cache is not None:
            base, start = self.prefix_cache.lookup(prompt)
        t0 = time.perf_counter()
        logits, cache = T.prefill_chunked(
            self.params, self.cfg, {"tokens": self._tokens(toks)}, chunk,
            capacity=self.capacity, impl=self.impl,
            cache=None if base is None else _grow_cache(base, self.capacity),
            start=start)
        tok = self._first_token(logits)
        self.prefill_s += self._tick(t0, "prefill")
        self.prefills += 1
        if self.prefix_cache is not None:
            # store only the chunk-aligned true prompt prefix (never pad
            # KV), as a copy: the entry must not pin the capacity-wide cache
            n = (S // chunk) * chunk
            if n > 0:
                entry = {kk: cache[kk][:, :, :n].clone() for kk in ("k", "v")}
                entry["pos"] = torch.full_like(cache["pos"], n)
                self.prefix_cache.insert(prompt, entry)
        return tok, cache, (len(toks) - start) // chunk

    def _prefill_chunked_paged(self, prompt, chunk):
        """Append chunk KV straight into this request's blocks (no dense
        B=1 cache), share prefix blocks through the refcounted
        PrefixCache, gather only the request's blocks as the payload."""
        Bs = self.block_size
        Lr = self._kv_layers
        if chunk % Bs:
            raise ValueError(f"chunk {chunk} is not block-aligned ({Bs})")
        S = len(prompt)
        toks = self._padded(prompt, chunk)
        Sp = len(toks)
        start, entry = 0, None
        if self.prefix_cache is not None:
            entry, start = self.prefix_cache.lookup(prompt)
        nb_total = Sp // Bs
        nb_prefix = start // Bs
        tbl = np.zeros((Lr, nb_total), np.int32)
        self._reserve(Lr * (nb_total - nb_prefix))
        if entry is not None:
            # a hit takes references on the entry's blocks and allocates
            # only the suffix
            tbl[:, :nb_prefix] = entry.ids[:, :nb_prefix]
            self._alloc.ref(tbl[:, :nb_prefix].ravel().tolist())
        fresh = self._alloc.alloc(Lr * (nb_total - nb_prefix))
        tbl[:, nb_prefix:] = np.asarray(fresh, np.int32).reshape(
            Lr, nb_total - nb_prefix)
        t0 = time.perf_counter()
        tbl_t = torch.as_tensor(tbl, device=self.device)
        logits, self.pool = T.prefill_chunked_paged(
            self.params, self.cfg, {"tokens": self._tokens(toks)}, chunk,
            self.pool, tbl_t, start=start, impl=self.impl)
        # the payload stays on the device (the reference copies it to
        # host numpy); a gather is a copy, so the pool blocks are free to go
        payload = PagedCache(T.gather_blocks(self.pool, tbl_t), Sp)
        tok = self._first_token(logits)
        self.prefill_s += self._tick(t0, "prefill")
        self.prefills += 1
        # the prefix entry keeps the chunk-aligned true prefix; pad blocks
        # go straight back to the pool. The request's refcounts move to
        # the entry.
        n = (S // chunk) * chunk
        nbk = n // Bs
        if self.prefix_cache is not None and nbk > 0:
            if nb_total > nbk:
                self._alloc.free(tbl[:, nbk:].ravel().tolist())
            self.prefix_cache.insert(prompt, PrefixBlocks(tbl[:, :nbk], n))
        else:
            self._alloc.free(tbl.ravel().tolist())
        return tok, payload, (Sp - start) // chunk

    # ---- decode role ----------------------------------------------------

    def has_free_slot(self) -> bool:
        return bool(self._free)

    @property
    def active(self) -> int:
        return len(self.slot_req)

    @torch.inference_mode()
    def insert(self, req, payload) -> int:
        """KV handoff: place a prefilled request into a free slot. Paged
        engines scatter only the request's blocks (O(request), not
        O(capacity)), and a jamba engine copies the SSM state into the
        slot's rows, in place; dense engines copy a cache-wide row (RWKV:
        the slot's whole state; hybrid: the ring and the SSM state)."""
        self._check()
        if self.paged and not isinstance(payload, PagedCache):
            raise TypeError("paged engine got a dense handoff payload; "
                            "mixed-layout fleets are unsupported")
        if not self.paged and isinstance(payload, PagedCache):
            raise TypeError("dense engine got a paged handoff payload; "
                            "mixed-layout fleets are unsupported")
        with span("repro_torch.engine.insert"):
            slot = self._free.pop()
            if self.paged:
                nbk = payload.blocks["k"].shape[1]
                Lr = self._kv_layers
                try:
                    self._reserve(Lr * nbk)
                    ids = np.asarray(self._alloc.alloc(Lr * nbk),
                                     np.int32).reshape(Lr, nbk)
                except BlockPoolExhausted:
                    self._free.append(slot)
                    raise
                T.scatter_blocks(self.pool,
                                 torch.as_tensor(ids, device=self.device),
                                 payload.blocks)
                for kk, t in payload.state.items():
                    self.pool[kk][:, slot].copy_(t)
                self._tables[:, slot, :] = 0
                self._tables[:, slot, :nbk] = ids
                self._pos[slot] = payload.length
            else:
                self._insert_dense(slot, payload)
        self.slot_req[slot] = req
        req.slot = slot
        req.engine_id = self.engine_id
        return slot

    def _insert_dense(self, slot: int, src) -> None:
        """Copy a B=1 cache into decode slot ``slot``, in place: K/V rows
        (and under kv-quant their scales) zero-padded or cut to the width
        of this engine's own cache (its capacity, or a sliding window's
        ring of W rows), every other entry (an RWKV or SSM state) as a
        whole row, as the reference's ``_insert_impl``."""
        for kk, dst_all in self.cache.items():
            if kk == "pos":
                continue
            dst = dst_all[:, slot]
            row = src[kk][:, 0]
            if kk in ("k", "v", "k_scale", "v_scale"):
                row = row[:, :dst.shape[1]]
                dst[:, row.shape[1]:] = 0
                dst = dst[:, :row.shape[1]]
            dst.copy_(row)
        self.cache["pos"][slot] = src["pos"][0]

    def evict(self, slot: int):
        """Free a slot. Paged: each of the request's blocks is one
        refcount decrement — no tensor traffic at all."""
        req = self.slot_req.pop(slot, None)
        if req is not None:
            req.slot = None
        if self.paged:
            row = self._tables[:, slot, :]
            live = row[row != 0]
            if live.size:
                self._alloc.free(live.tolist())
            self._tables[:, slot, :] = 0
            self._pos[slot] = 0
        self._free.append(slot)

    def _stage(self, tokens_by_slot: Dict[int, int], nb: int):
        """The paged step's inputs for window ``nb``: (tables [L, slots, nb]
        int32, pos [slots] int32, tokens [slots] int64), views of the
        device staging buffer, filled from one host copy. The same window
        always gives the same views, which are its graph's inputs. The
        host buffer is written again only after the step's closing
        synchronise, when the copy out of it has finished."""
        S, Lr = self.slots, self._kv_layers
        n = 3 * S + Lr * S * nb
        host = self._stage_host.numpy()
        toks = host[:2 * S].view(np.int64)
        toks[:] = 0
        for s, t in tokens_by_slot.items():
            toks[s] = t
        host[2 * S:3 * S] = self._pos
        host[3 * S:n].reshape(Lr, S, nb)[:] = self._tables[:, :, :nb]
        dev = self._stage_dev
        if dev is not self._stage_host:
            dev[:n].copy_(self._stage_host[:n], non_blocking=True)
        return (dev[3 * S:n].view(Lr, S, nb), dev[2 * S:3 * S],
                dev[:2 * S].view(torch.int64))

    def _step_tokens(self, tokens_by_slot: Dict[int, int]) -> torch.Tensor:
        toks = np.zeros((self.slots,), np.int64)
        for s, t in tokens_by_slot.items():
            toks[s] = t
        return torch.as_tensor(toks, device=self.device)

    @torch.inference_mode()
    def decode_step(self, tokens_by_slot: Dict[int, int]) -> Dict[int, int]:
        """One token for every active slot. Returns slot -> next token."""
        self._check()
        with span("repro_torch.engine.decode"):
            if self.paged:
                return self._decode_step_paged(tokens_by_slot)
            t0 = time.perf_counter()
            logits, self.cache = T.decode_step(
                self.params, self.cfg, self.cache,
                self._step_tokens(tokens_by_slot), impl=self.impl)
            with span("repro_torch.engine.decode.readback"):
                nxt = torch.argmax(logits[:, :self.cfg.vocab_size],
                                   dim=-1).tolist()
                self.decode_s += self._tick(t0, "decode")
        self.decode_steps += 1
        return {s: int(nxt[s]) for s in tokens_by_slot}

    def _decode_step_paged(self, tokens_by_slot: Dict[int, int]):
        Bs = self.block_size
        Lr = self._kv_layers
        with span("repro_torch.engine.decode.prepare"):
            # grow: a slot whose next write crosses a block boundary gets a
            # fresh block per layer before the step (O(1) host work)
            for s in tokens_by_slot:
                bi = int(self._pos[s]) // Bs
                if bi < self._nb_max and self._tables[0, s, bi] == 0:
                    self._reserve(Lr)
                    self._tables[:, s, bi] = self._alloc.alloc(Lr)
            # pow2-bucketed window over the active context: the attention
            # width tracks what is live instead of the full per-slot
            # capacity
            mx = max(int(self._pos[s]) for s in tokens_by_slot)
            nb = window_blocks(mx, Bs, self._nb_max)
            t0 = time.perf_counter()
            tables, pos, toks = self._stage(tokens_by_slot, nb)
        captured = self._capture_s()
        logits, self.pool, _ = T.decode_step_paged(
            self.params, self.cfg, self.pool, tables, pos, toks,
            impl=self.impl, graphs=self._graphs)
        with span("repro_torch.engine.decode.readback"):
            nxt = torch.argmax(logits[:, :self.cfg.vocab_size],
                               dim=-1).tolist()
            for s in tokens_by_slot:
                self._pos[s] += 1
            self.decode_s += self._tick(t0, "decode",
                                        self._capture_s() - captured)
        self.decode_steps += 1
        return {s: int(nxt[s]) for s in tokens_by_slot}

    @property
    def mean_step_s(self) -> float:
        """The mean of the last 50 steps of the kind the engine ran last:
        what the straggler detector compares between the engines of one
        pool. Steps of the other kind, which an engine moved between pools
        brings along, are left out: a graphed decode step takes a fifth of
        a prefill's time, and a mean over both drains a sound engine."""
        recent = self._recent[self._last_kind]
        return float(np.mean(recent)) if recent else 0.0
