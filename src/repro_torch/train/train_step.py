"""Train step: loss + grads (accumulated over microbatches) + update; the
port's copy of ``repro.train.train_step``.

Grads come from ``torch.autograd``. As in the reference they are fp32:
each leaf is cast as it comes back from autograd, so a bf16 grad is freed
as its fp32 copy is made (the cast adds the fp32 copy, 13.6 GB for
qwen2.5-3b, never a second one). With ``cfg.grad_accum > 1`` the batch is
split into that many microbatches along its first axis and their grads are
summed in fp32 accumulators, then averaged: the activation working set
scales with the microbatch, not the global batch.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import constrain, current_mesh
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves, unflatten_like

f32 = torch.float32


def _split_microbatches(batch: Dict[str, Any], accum: int):
    """Microbatch i is rows [i*B/accum, (i+1)*B/accum), as in the
    reference. Under a mesh the (small) batch is gathered, split, and each
    microbatch laid out over the data axes again, the reshard GSPMD makes
    of the reference's reshape: a batch sharded 16 ways does not fold into
    8 microbatches where it lies."""
    def sp(x):
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "microbatches")
        rest = (None,) * (x.dim() - 1)
        if isinstance(x, DTensor) and current_mesh() is not None:
            x = x.redistribute(x.device_mesh,
                               (Replicate(),) * x.device_mesh.ndim)
            return constrain(x.reshape(accum, B // accum, *x.shape[1:]),
                             None, "dp", *rest)
        return x.reshape(accum, B // accum, *x.shape[1:])
    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def _grads(params, cfg: ModelConfig, batch):
    """(loss, metrics, grads in autograd's dtypes, a list in pytree
    order). The loss is taken of views of ``params`` that require grad,
    so the caller's tensors are left as they were. A parameter the loss
    does not read (the SSM's ``dt_bias``, in the reference too) gets a zero
    grad, as ``jax.grad`` gives it."""
    views = [p.detach().requires_grad_() for p in leaves(params)]
    loss, metrics = T.train_loss(unflatten_like(params, views), cfg, batch)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(
        views, torch.autograd.grad(loss, views, allow_unused=True))]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def loss_and_grad(params, cfg: ModelConfig, batch):
    """Full-batch (or accumulated) loss, metrics and fp32 grads (a tree
    shaped like ``params``)."""
    if cfg.grad_accum <= 1:
        loss, metrics, grads = _grads(params, cfg, batch)
        for i, g in enumerate(grads):
            grads[i] = g.float()
        return loss, metrics, unflatten_like(params, grads)

    n = cfg.grad_accum
    g_acc = [torch.zeros_like(p, dtype=f32) for p in leaves(params)]
    loss_sum = torch.zeros((), dtype=f32, device=g_acc[0].device)
    per_mb = []
    for mb in _split_microbatches(batch, n):
        loss, metrics, grads = _grads(params, cfg, mb)
        for a, g in zip(g_acc, grads):
            a += g.float()
        del grads
        loss_sum = loss_sum + loss
        per_mb.append(metrics)
    for a in g_acc:
        a /= n
    metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
               for k in per_mb[0]}
    return loss_sum / n, metrics, unflatten_like(params, g_acc)


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    max_grad_norm: float = 1.0):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics); params and opt_state are updated in place."""

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = loss_and_grad(params, cfg, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm})
        return params, opt_state, metrics

    return train_step
