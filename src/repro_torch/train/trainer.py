"""Training loop: checkpoint/restart fault tolerance + straggler
detection; the port's copy of ``repro.train.trainer``.

Restart semantics: params/opt_state/step are restored from the latest
intact checkpoint and the data pipeline is re-synced by step number
(batches are a pure function of step), so a crash at any point replays
identically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpoint import (latest_step, prune_checkpoints,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than `factor` x EWMA.

    On a real pod the flag feeds the controller that drains/replaces the slow
    host (serving does exactly that in serving/elastic.py); in-process we
    record and expose the events.
    """
    alpha: float = 0.1
    factor: float = 3.0
    ewma: Optional[float] = None
    events: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow


class Trainer:
    """Trains ``cfg`` on ``data`` (whose batches lie on ``device``, default
    ``cuda``) from the port's ``init_params(cfg, seed)`` or the latest
    checkpoint under ``ckpt_dir``. Params and optimizer state are updated
    in place, step by step."""

    def __init__(self, cfg: ModelConfig, data, *, ckpt_dir: str,
                 ckpt_every: int = 50, keep: int = 3,
                 lr: float = 3e-4, seed: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.device = resolve_device(device)
        self.opt = make_optimizer(cfg.optimizer, lr=lr)
        self.monitor = StragglerMonitor()
        self._step_fn = make_train_step(cfg, self.opt)
        self._seed = seed
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: List[Dict] = []

    # -- state ---------------------------------------------------------

    def init_or_restore(self):
        self.params = T.init_params(self.cfg, self._seed, device=self.device)
        self.opt_state = self.opt.init(self.params)
        if latest_step(self.ckpt_dir) is not None:
            tree = {"params": self.params, "opt": self.opt_state}
            tree, step, extra = restore_checkpoint(self.ckpt_dir, tree)
            self.params = tree["params"]
            self.opt_state = tree["opt"]
            self.step = step
        return self.step

    def checkpoint(self):
        save_checkpoint(self.ckpt_dir, self.step,
                        {"params": self.params, "opt": self.opt_state},
                        extra={"name": self.cfg.name})
        prune_checkpoints(self.ckpt_dir, self.keep)

    # -- loop ----------------------------------------------------------

    def train(self, num_steps: int, *,
              fail_at: Optional[int] = None,
              on_step: Optional[Callable[[int, Dict], None]] = None) -> Dict:
        """Run to global step `num_steps`. `fail_at` injects a crash (tests).
        A step's ``step_s`` ends when the device has finished it."""
        if self.params is None:
            self.init_or_restore()
        while self.step < num_steps:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at step {self.step}")
            batch = self.data.batch_at(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.monitor.observe(self.step, dt)
            metrics["step_s"] = dt
            self.history.append({"step": self.step, **metrics})
            if on_step:
                on_step(self.step, metrics)
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.checkpoint()
        self.checkpoint()
        return self.history[-1] if self.history else {}
