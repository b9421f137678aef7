"""Executable serving engine on PyTorch: prefill and decode on the card.

One ``Engine`` = one model instance (shared params + step functions)
playing a *role* (prefill / decode); engines are role-reassignable at
runtime, so elastic scaling is a pool-list operation. It has the surface
``Cluster`` drives: ``prefill``, ``insert``, ``evict``, ``decode_step``,
``has_free_slot``, ``active``, ``fail``, ``slow_down``,
``capacity_weight``, ``describe``, ``step_times``, ``slot_req``,
``prefix_cache`` (None), ``paged``, ``mean_step_s`` and ``_alloc``.

This slice ports the **paged** KV layout of ``repro.serving.engine``: KV
lives in a block pool ``[num_blocks, block_size, Hkvp, dh]`` shared by all
layers and slots, addressed through per-layer block tables (the host-side
refcounts are ``serving/blocks.py``). ``insert`` scatters only the
request's blocks, ``evict`` is an O(1) refcount decrement per block, and
decode attends over a pow2-bucketed window that tracks the active context.
The dense layout, chunked prefill and the prefix cache come with the next
slice.

On a CUDA device every prefill runs the hand-written flash-attention
kernel and every decode step the paged decode kernel (``impl="kernel"``);
on the CPU the same calls run their plain PyTorch versions. The kernels
are built when the engine is made, never inside a timed step.

Time: an engine built with a ``ChipConfig`` scales its measured step wall
times by ``1 / relative_speed(chip, GPU_H100)``. The reference chip is the
card the port runs on, so an ``h100`` engine's virtual clock reads measured
H100 time unscaled (the JAX engine's reference chip is ``TPU_V5E``). Every
timed window ends in ``torch.cuda.synchronize()``, so the clock measures
the step and not its enqueue.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import GPU_H100, ChipConfig, relative_speed
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.blocks import BlockAllocator, BlockPoolExhausted
from repro_torch.serving.common import EngineFailure, StepLog

NEXT_SLICE = ("the dense KV layout, chunked prefill and the prefix cache "
              "come with the next slice of the port (chunked prefill on the "
              "flash kernel's q_offset, dense decode on kernel 3)")


class PagedCache:
    """Paged KV-handoff payload: the request's own blocks, free-floating
    (gathered off the source pool). ``nbytes`` is the actual transfer size
    — block-rounded true length, not the slot capacity — which is what
    ``cluster.kv_bytes`` reads."""

    __slots__ = ("blocks", "length")

    def __init__(self, blocks: Dict[str, torch.Tensor], length: int):
        self.blocks = blocks            # {"k","v": [L, nb, Bs, Hkvp, dh]}
        self.length = int(length)

    @property
    def nbytes(self) -> int:
        bk = self.blocks["k"]
        return 2 * bk.numel() * bk.element_size()


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
        if paged is False or not T.supports_paged(cfg):
            raise NotImplementedError(f"{cfg.name}: only the paged layout "
                                      f"is ported; {NEXT_SLICE}")
        if chunk_size:
            raise NotImplementedError(f"chunk_size={chunk_size}: "
                                      f"{NEXT_SLICE}")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        self.engine_id = engine_id
        self.cfg = cfg
        self.params = params            # shared, never copied, by engines
        self.slots = slots
        self.capacity = capacity
        self.chunk_size = 0
        self.healthy = True
        self.clock = 0.0
        self.step_times = StepLog(step_history)
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

        self.paged = True
        self.prefix_cache = None
        self.block_size = block_size
        self._free = list(range(slots))
        self.slot_req: Dict[int, Any] = {}
        Lr = cfg.num_layers
        self._nb_max = -(-capacity // block_size)
        if pool_blocks is None:
            # full decode occupancy + in-flight prefill + prefix headroom
            pool_blocks = 1 + Lr * self._nb_max * (slots + 4)
        self.pool = T.init_block_pool(cfg, pool_blocks, block_size,
                                      device=self.device)
        self._alloc = BlockAllocator(pool_blocks)
        self._tables = np.zeros((Lr, slots, self._nb_max), np.int32)
        self._pos = np.zeros((slots,), np.int32)

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
                "block_size": self.block_size,
                "speed_factor": self.speed_factor,
                "capacity_weight": self.capacity_weight,
                "device": str(self.device), "impl": self.impl}

    def _tick(self, t0: float):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = ((time.perf_counter() - t0) * self.speed_factor
              * self._slow_factor)
        self.clock += dt
        self.step_times.append(dt)
        return dt

    def _check(self):
        if not self.healthy:
            raise EngineFailure(f"engine {self.engine_id} is down")

    def _reserve(self, n: int):
        if not self._alloc.can_alloc(n):
            raise BlockPoolExhausted(
                f"engine {self.engine_id}: need {n} blocks, "
                f"{self._alloc.num_free} free")

    # ---- prefill role ---------------------------------------------------

    def _prefill_payload(self, tokens: torch.Tensor):
        """Full prefill -> (logits, handoff blocks). The B=1 cache is padded
        to whole blocks and reshaped to [L, nb, Bs, Hkvp, dh] (block-padded
        true length, never the slot capacity); logits come before any
        padding. The payload stays on the device."""
        logits, cache = T.prefill_full(self.params, self.cfg,
                                       {"tokens": tokens}, impl=self.impl)
        S = tokens.shape[1]
        Bs = self.block_size
        Sb = -(-S // Bs) * Bs
        blocks = {}
        for kk in ("k", "v"):
            row = cache[kk][:, 0]                         # [L, S, Hkvp, dh]
            if Sb > S:
                row = torch.cat([row, row.new_zeros(
                    (row.shape[0], Sb - S) + tuple(row.shape[2:]))], dim=1)
            blocks[kk] = row.reshape(row.shape[0], Sb // Bs, Bs,
                                     *row.shape[2:])
        return logits, blocks

    @torch.inference_mode()
    def prefill(self, prompt: np.ndarray) -> Tuple[int, Any]:
        """Full prefill of one prompt; returns (first_token, payload)."""
        self._check()
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=self.device)[None, :]
        logits, blocks = self._prefill_payload(tokens)
        tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
        self.prefill_s += self._tick(t0)
        self.prefills += 1
        return tok, PagedCache(blocks, len(prompt))

    def prefill_chunked(self, prompt: np.ndarray, chunk: int,
                        on_chunk=None) -> Tuple[int, Any]:
        raise NotImplementedError(f"prefill_chunked: {NEXT_SLICE}")

    # ---- decode role ----------------------------------------------------

    def has_free_slot(self) -> bool:
        return bool(self._free)

    @property
    def active(self) -> int:
        return len(self.slot_req)

    @torch.inference_mode()
    def insert(self, req, payload: PagedCache) -> int:
        """KV handoff: place a prefilled request into a free slot, scattering
        only the request's blocks (O(request), not O(capacity))."""
        self._check()
        if not isinstance(payload, PagedCache):
            raise TypeError(f"paged engine got a {type(payload).__name__} "
                            "handoff payload")
        slot = self._free.pop()
        nbk = payload.blocks["k"].shape[1]
        Lr = self.cfg.num_layers
        try:
            self._reserve(Lr * nbk)
            ids = np.asarray(self._alloc.alloc(Lr * nbk),
                             np.int32).reshape(Lr, nbk)
        except BlockPoolExhausted:
            self._free.append(slot)
            raise
        T.scatter_blocks(self.pool, torch.as_tensor(ids, device=self.device),
                         payload.blocks)
        self._tables[:, slot, :] = 0
        self._tables[:, slot, :nbk] = ids
        self._pos[slot] = payload.length
        self.slot_req[slot] = req
        req.slot = slot
        req.engine_id = self.engine_id
        return slot

    def evict(self, slot: int):
        """Free a slot: each of the request's blocks is one refcount
        decrement — no tensor traffic at all."""
        req = self.slot_req.pop(slot, None)
        if req is not None:
            req.slot = None
        row = self._tables[:, slot, :]
        live = row[row != 0]
        if live.size:
            self._alloc.free(live.tolist())
        self._tables[:, slot, :] = 0
        self._pos[slot] = 0
        self._free.append(slot)

    @torch.inference_mode()
    def decode_step(self, tokens_by_slot: Dict[int, int]) -> Dict[int, int]:
        """One token for every active slot. Returns slot -> next token."""
        self._check()
        Bs = self.block_size
        Lr = self.cfg.num_layers
        # grow: a slot whose next write crosses a block boundary gets a
        # fresh block per layer before the step (O(1) host work)
        for s in tokens_by_slot:
            bi = int(self._pos[s]) // Bs
            if bi < self._nb_max and self._tables[0, s, bi] == 0:
                self._reserve(Lr)
                self._tables[:, s, bi] = self._alloc.alloc(Lr)
        # pow2-bucketed window over the active context: the attention width
        # tracks what is live instead of the full per-slot capacity
        mx = max(int(self._pos[s]) for s in tokens_by_slot)
        nb = 1
        while nb * Bs <= mx:
            nb *= 2
        nb = min(nb, self._nb_max)
        t0 = time.perf_counter()
        toks = np.zeros((self.slots,), np.int64)
        for s, t in tokens_by_slot.items():
            toks[s] = t
        dev = self.device
        tables = torch.as_tensor(np.ascontiguousarray(self._tables[:, :, :nb]),
                                 device=dev)
        logits, self.pool, _ = T.decode_step_paged(
            self.params, self.cfg, self.pool, tables,
            torch.as_tensor(self._pos, device=dev),
            torch.as_tensor(toks, device=dev), impl=self.impl)
        nxt = torch.argmax(logits[:, :self.cfg.vocab_size], dim=-1).tolist()
        for s in tokens_by_slot:
            self._pos[s] += 1
        self.decode_s += self._tick(t0)
        self.decode_steps += 1
        return {s: int(nxt[s]) for s in tokens_by_slot}

    @property
    def mean_step_s(self) -> float:
        if not self.step_times:
            return 0.0
        return float(np.mean(self.step_times[-50:]))
