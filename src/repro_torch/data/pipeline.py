"""Deterministic, resumable synthetic token pipeline (+ memmap file
source): the port's copy of ``repro.data.pipeline``, numpy inside.

Batches are a pure function of (seed, step) — restart at step k reproduces
the exact stream without data-loader state in the checkpoint — and equal
the reference's token for token. Sequences have Zipf-ish marginals + local
structure so the LM loss is learnable. ``batch_at`` returns int32 tensors
on the pipeline's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None     # optional tokenized .bin (uint16/uint32)


def _batch(tokens: np.ndarray, labels: np.ndarray, device
           ) -> Dict[str, torch.Tensor]:
    return {"tokens": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device)}


class SyntheticLM:
    """Order-1 Markov-ish stream: learnable structure, deterministic."""

    def __init__(self, cfg: DataConfig, *, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # sparse transition preferences: each token strongly suggests 4 others
        self.next_pref = rng.integers(0, V, size=(V, 4)).astype(np.int64)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.zipf(1.3, size=B) % V
        choice = rng.integers(0, 4, size=(B, S))
        noise = rng.random((B, S))
        rand_tok = rng.integers(0, V, size=(B, S))
        for t in range(1, S):
            follow = self.next_pref[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t] < 0.8, follow, rand_tok[:, t])
        tokens = toks.astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]],
                                axis=1).astype(np.int32)
        return _batch(tokens, labels, self.device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Reads a flat tokenized binary; deterministic strided batches."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16, *,
                 device: DeviceLike = None):
        if not cfg.path:
            raise ValueError("MemmapLM needs a path")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        n = len(self.data) - S - 1
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=B)
        toks = np.stack([self.data[s:s + S] for s in starts]).astype(np.int32)
        labels = np.stack([self.data[s + 1:s + S + 1]
                           for s in starts]).astype(np.int32)
        return _batch(toks % cfg.vocab_size, labels % cfg.vocab_size,
                      self.device)


def make_pipeline(cfg: ModelConfig, seq_len: int, global_batch: int,
                  seed: int = 0, path: Optional[str] = None, *,
                  device: DeviceLike = None):
    """A ``MemmapLM`` over ``path`` or a ``SyntheticLM``, whose batches
    land on ``device`` (default ``cuda``; raises with no card)."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                    global_batch=global_batch, seed=seed, path=path)
    return (MemmapLM(dc, device=device) if path
            else SyntheticLM(dc, device=device))
