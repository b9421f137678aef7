"""AdamW and Adafactor (factored, for >=100B params) on trees of tensors:
the port's copy of ``repro.train.optimizer``.

Adafactor keeps O(rows+cols) second-moment state for matrices instead of
O(rows*cols) — the difference between kimi-k2 (1T params) fitting a
256-chip pod or not (DESIGN.md §8).

The arithmetic is the reference's: every update in fp32, the new
parameter cast back to its own dtype. Adafactor's factored moments and its
update clipping are taken over whole leaves of the reference's tree, where
a block leaf is stacked over the layers ([L, ...]): the port stacks each
block leaf's layers for its update (``_groups``), and keeps the state in
those stacked shapes, keyed by the stacked leaf's path
(``blocks/wq``). Where the reference's ``update``
returns new trees, the port's writes the parameters and the state in
place and returns the same trees: a second copy of a model's parameters
and moments would not fit beside them on one card. The step count and
the learning rate are fp32 scalars on the host, as the reference's
``jnp`` scalars, so no update waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import flatten_with_paths, leaves, map_tree

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (params, state), in place


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step, dtype=f32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """Scales every leaf by min(1, max_norm / global norm), in fp32 and
    cast back to the leaf's dtype, in place (the step's own gradients;
    the reference returns a new tree of the same values). Returns (tree,
    norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in leaves(tree):
        x.copy_((x.float() * scale).to(x.dtype))
    return tree, norm


def _count(state) -> torch.Tensor:
    return state["count"] + 1


def _groups(tree):
    """[(path, [tensors])]: each leaf outside ``blocks`` alone, and each
    block leaf with its counterparts in every layer — the leaves of the
    reference's tree, whose blocks are stacked [L, ...]."""
    groups = [(path, [leaf]) for path, leaf in flatten_with_paths(
        {k: v for k, v in tree.items() if k != "blocks"})]
    layers = [dict(flatten_with_paths(b)) for b in tree.get("blocks", [])]
    if layers:
        groups += [(f"blocks/{path}", [layer[path] for layer in layers])
                   for path in layers[0]]
    return groups


def _stacked(ts):
    return ts[0] if len(ts) == 1 else torch.stack(ts)


# ---------------------------------------------------------------------------
# AdamW


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=f32, device=p.device)
        return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params, step):
        count = _count(state)
        lr = lr_fn(step)
        bc1 = 1 - b1 ** count.to(f32)
        bc2 = 1 - b2 ** count.to(f32)
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                              leaves(state["v"]), leaves(params)):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        state["count"] = count
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), no-momentum variant


def adafactor(lr_fn, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2

    def init(params):
        def st(ps):
            shape = ((len(ps),) if len(ps) > 1 else ()) + tuple(ps[0].shape)
            dev = ps[0].device
            if _factored(shape):
                return {"vr": torch.zeros(shape[:-1], dtype=f32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          dtype=f32, device=dev)}
            return {"v": torch.zeros(shape, dtype=f32, device=dev)}
        return {"s": {path: st(ps) for path, ps in _groups(params)},
                "count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params, step):
        count = _count(state)
        lr = lr_fn(step)
        beta = 1.0 - (count.to(f32) + 1.0) ** (-decay)
        for (path, ps), (_, gs) in zip(_groups(params), _groups(grads)):
            s = state["s"][path]
            p, g = _stacked(ps), _stacked(gs).float()
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
                denom = torch.clamp(s["vr"].mean(dim=-1, keepdim=True),
                                    min=eps)
                vhat = (s["vr"][..., None] * s["vc"][..., None, :]) \
                    / denom[..., None]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                vhat = s["v"]
            u = g / torch.sqrt(vhat + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            delta = u + weight_decay * p.float()
            new = (p.float() - lr * delta).to(p.dtype)
            for i, t in enumerate(ps):
                t.copy_(new if len(ps) == 1 else new[i])
        state["count"] = count
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000) -> Optimizer:
    lr_fn = cosine_schedule(lr, warmup, total)
    if name == "adamw":
        return adamw(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    raise ValueError(f"unknown optimizer {name!r}")
