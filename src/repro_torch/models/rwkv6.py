"""RWKV-6 "Finch" block: the PyTorch counterpart of ``repro.models.rwkv6``.

Data-dependent per-token, per-channel decay ``w_t = exp(-exp(w0 +
lora(x)))`` and the WKV recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the reference's simplification kept: the r/k/v/g token-shift
interpolators use a static ``mu``; only the decay keeps its LoRA.

``impl="kernel"`` runs every WKV through ``kernels.rwkv6.ops.wkv`` (the
CUDA kernel on a card, its plain chunked form on a CPU tensor): the whole
prompt at prefill and one token (S = 1) per decode step. ``impl="plain"``
runs ``wkv_chunked`` / ``wkv_step``, as ``"xla"`` does (the reference's
default, which the dry run traces).

The state dict ``{"s": [B,H,N,N] fp32, "tm_x", "cm_x": [B,D]}`` is updated
in place by both impls, where the reference returns new arrays: the
engine's cache rows are the state, so a decode step copies nothing.

Under a device mesh (``parallel.sharding.use_mesh``) the block constrains
its outputs to the reference's layouts, and the plain WKV runs on each
rank's batch and heads (``shard_map``): the recurrence is independent
per (sequence, head). A fresh state (a prefill's) is laid out so first.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, rms_norm, split_heads
from repro_torch.parallel.sharding import (constrain, current_mesh, pin,
                                           placements_for, shard_map,
                                           shard_map_placements)

f32 = torch.float32
DECAY_LORA = 64
GROUP_NORM_EPS = 64e-5
IMPLS = ("kernel", "plain", "xla")   # "xla" is "plain" (the reference's)


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, *, device
                    ) -> Dict[str, torch.Tensor]:
    """One block's parameters with the reference's distributions
    (``init_rwkv_block``): uniform ``mu``/``cm_mu``, ``w0 = -0.6``, a zero
    ``w_lora_b``, ``u ~ N(0, 0.25)``, ``ln_x = 1``; ``w0``, ``u`` and
    ``ln_x`` stay fp32 in a bf16 configuration."""
    D, H = cfg.d_model, cfg.num_heads
    N = D // H
    dt = cfg.tdtype
    s = 1.0 / math.sqrt(D)

    meta = torch.device(device).type == "meta"    # shapes only, no draws

    def normal(shape, std):
        if meta:
            return torch.empty(shape, dtype=f32, device=device)
        return torch.randn(shape, generator=gen, dtype=f32,
                           device=device) * std

    def uniform(shape):
        if meta:
            return torch.empty(shape, dtype=f32, device=device)
        return torch.rand(shape, generator=gen, dtype=f32, device=device)

    def lin(shape):
        return normal(shape, s).to(dt)

    return {
        "tm_norm": torch.ones((D,), dtype=dt, device=device),
        "cm_norm": torch.ones((D,), dtype=dt, device=device),
        "mu": uniform((5, D)).to(dt),                      # r,k,v,g,w
        "w0": torch.full((D,), -0.6, dtype=f32, device=device),
        "w_lora_a": lin((D, DECAY_LORA)),
        "w_lora_b": torch.zeros((DECAY_LORA, D), dtype=dt, device=device),
        "u": normal((H, N), 0.5),
        "wr": lin((D, D)),
        "wk": lin((D, D)),
        "wv": lin((D, D)),
        "wg": lin((D, D)),
        "wo": lin((D, D)),
        "ln_x": torch.ones((H, N), dtype=f32, device=device),
        "cm_mu": uniform((2, D)).to(dt),                   # r,k
        "cm_wk": lin((D, cfg.d_ff)),
        "cm_wv": lin((cfg.d_ff, D)),
        "cm_wr": lin((D, D)),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, *, device):
    """Per-layer recurrent state (the RWKV counterpart of a KV cache)."""
    D, H = cfg.d_model, cfg.num_heads
    N = D // H
    return {"s": torch.zeros((batch, H, N, N), dtype=f32, device=device),
            "tm_x": torch.zeros((batch, D), dtype=cfg.tdtype, device=device),
            "cm_x": torch.zeros((batch, D), dtype=cfg.tdtype, device=device)}


def _shift(x, prev):
    """Token shift: x_{t-1} for each t of x [B,S,D]; prev is x_{-1} [B,D]."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _group_norm_gate(p, y, g, dt):
    """Per-head group norm of y [..., H, N] (fp32, population variance),
    the fp32 gate g [..., D], then the output projection in ``dt``."""
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + GROUP_NORM_EPS) * p["ln_x"]
    # (pinned: the view's gradient must come back in whole heads)
    return constrain(linear((pin(y.reshape(g.shape)) * g).to(dt), p["wo"]),
                     "dp", *(None,) * (g.dim() - 1))


def _time_mix_inputs(p, xn, xx):
    """r, k, v (in ``dt``), the fp32 gate and fp32 log-decay from the
    normed input xn and the shift difference xx (both [..., D], taken in
    ``dt`` as the reference does)."""
    dt = xn.dtype
    mu = p["mu"].to(f32)
    xr, xk, xv, xg, xw = (xn.to(f32) + xx.to(f32) * mu[i] for i in range(5))
    r = linear(xr.to(dt), p["wr"])
    k = linear(xk.to(dt), p["wk"])
    v = linear(xv.to(dt), p["wv"])
    g = F.silu(linear(xg.to(dt), p["wg"]).to(f32))
    lora = linear(torch.tanh(linear(xw.to(dt), p["w_lora_a"])),
                  p["w_lora_b"])
    logw = -torch.exp(p["w0"] + lora.to(f32))          # log w_t <= 0
    return r, k, v, g, logw


def _channel_mix(p, xn2, xx2):
    dt = xn2.dtype
    cmu = p["cm_mu"].to(f32)
    xx2 = xx2.to(f32)
    cr = (xn2.to(f32) + xx2 * cmu[0]).to(dt)
    ck = (xn2.to(f32) + xx2 * cmu[1]).to(dt)
    kk = torch.square(torch.relu(linear(ck, p["cm_wk"]).to(f32))).to(dt)
    lead = (None,) * (kk.dim() - 2)
    cv = linear(constrain(kk, "dp", *lead, "tp"), p["cm_wv"])
    return constrain(torch.sigmoid(linear(cr, p["cm_wr"]).to(f32)).to(dt)
                     * cv,
                     "dp", *lead, None)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


_STATE = {"s": ("dp", "tp", None, None), "tm_x": ("dp", None),
          "cm_x": ("dp", None)}
_RKV = ("dp", None, "tp", None)         # r, k, v, logw [B,S,H,N]


def _laid_out(state):
    """Under a mesh, a state of plain tensors (a fresh one) as DTensors in
    the reference's layout; else the state itself."""
    mesh = current_mesh()
    if mesh is None or isinstance(state["s"], DTensor):
        return state
    rep = (Replicate(),) * mesh.ndim
    return {key: DTensor.from_local(t, mesh, rep, run_check=False)
            .redistribute(mesh, placements_for(t.shape, *_STATE[key]))
            for key, t in state.items()}


def rwkv_block(p, x, state, cfg: ModelConfig, *, impl: str = "kernel"
               ) -> Tuple[torch.Tensor, dict]:
    """x: [B,S,D]; state: this layer's state dict, updated in place (under
    a mesh a fresh state's laid-out copy is). Returns (x, state)."""
    _check_impl(impl)
    B, S, D = x.shape
    H = cfg.num_heads
    N = D // H
    dt = x.dtype
    if isinstance(x, DTensor):
        state = _laid_out(state)

    xn = rms_norm(x, p["tm_norm"], cfg.norm_eps)
    xx = _shift(xn, state["tm_x"]) - xn
    r, k, v, g, logw = _time_mix_inputs(p, xn, xx)
    r, k, v, logw = (split_heads(a, H, N) for a in (r, k, v, logw))
    u = p["u"].to(f32)
    if impl == "kernel":
        y, _ = wkv(r, k, v, logw, u, state["s"], out_state=state["s"])
    else:
        # from a copy: the training forward differentiates through the
        # chunked form, which keeps its input state for the backward pass
        y, s_new = shard_map(
            wkv_chunked, (r, k, v, logw, u, state["s"].clone()),
            (_RKV,) * 4 + (("tp", None), _STATE["s"]),
            lambda pl: (pl[0], pl[5]))
        state["s"].copy_(s_new)
    x = x + _group_norm_gate(p, y, g, dt)

    xn2 = rms_norm(x, p["cm_norm"], cfg.norm_eps)
    x = x + _channel_mix(p, xn2, _shift(xn2, state["cm_x"]) - xn2)
    state["tm_x"].copy_(xn[:, -1])
    state["cm_x"].copy_(xn2[:, -1])
    return x, state


def rwkv_block_step(p, x, state, cfg: ModelConfig, *, impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, dict]:
    """One decode token. x: [B,1,D]; state updated in place. Returns
    (x, state). The kernel runs the token as an S = 1 sequence, which is
    exactly ``wkv_step``."""
    _check_impl(impl)
    B, _, D = x.shape
    H = cfg.num_heads
    N = D // H
    dt = x.dtype

    xn = rms_norm(x, p["tm_norm"], cfg.norm_eps)[:, 0]            # [B,D]
    r, k, v, g, logw = _time_mix_inputs(p, xn, state["tm_x"] - xn)
    u = p["u"].to(f32)
    if impl == "kernel":
        y, _ = wkv(*(a.reshape(B, 1, H, N) for a in (r, k, v, logw)), u,
                   state["s"], out_state=state["s"])
        y = y[:, 0]
    else:
        s_pl = (state["s"].placements if isinstance(state["s"], DTensor)
                else None)
        step = tuple(split_heads(a, H, N) for a in (r, k, v, logw))
        if s_pl is None:
            y, s_new = wkv_step(*step, u, state["s"])
        else:       # on each rank's rows and heads of the cached state
            hd = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate()
                       for pl in s_pl)
            u_pl = tuple(Shard(0) if pl == Shard(1) else Replicate()
                         for pl in s_pl)
            y, s_new = shard_map_placements(
                wkv_step, (*step, u, state["s"]), (hd,) * 4 + (u_pl, s_pl),
                (hd, s_pl))
        state["s"].copy_(s_new)
    x = x + _group_norm_gate(p, y, g, dt)[:, None, :]

    xn2 = rms_norm(x, p["cm_norm"], cfg.norm_eps)[:, 0]
    x = x + _channel_mix(p, xn2, state["cm_x"] - xn2)[:, None, :]
    state["tm_x"].copy_(xn)
    state["cm_x"].copy_(xn2)
    return x, state
