"""Selective SSMs: the Mamba-style branch of the hymba hybrid block (the
PyTorch counterpart of ``repro.models.ssm``) and the Mamba-1 mixer of
Jamba's layers (``mamba_apply``, ``mamba_step``).

The linear time-varying recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,    y_t = C_t h_t + D x_t

with input-dependent (dt, B, C) and a single shared dt channel per
position, as in the reference. ``ssm_apply`` runs a prompt through
``_prompt_scan``; ``ssm_step`` runs one token. Under ``impl="kernel"`` on
the card a prompt's scan is the port's selective-scan kernel
(``kernels/selective_scan``), one launch a layer: the JAX package
evaluates it with XLA's ``associative_scan`` and has no Pallas kernel for
it. Its plain version, and the path of ``impl="plain"`` and of the
training forward (no kernel has a backward), is ``_scan``: the prompt in
chunks of 256 positions (zero-padded to whole chunks: a pad position has
dt = 0, so a = 1 and b = 0 and the state passes through it unchanged),
each chunk by a Hillis-Steele doubling scan, log2(256) = 8 steps of
whole-chunk tensor ops.

The state ``{"h": [B,di,ds] fp32, "conv": [B,K-1,di]}`` comes back as new
tensors; the model copies it into its cache rows. Under a device mesh
(``parallel.sharding.use_mesh``) a prompt's convolution and scan run on
each rank's batch and channels (the kernel on each rank's local tensors).

Jamba's Mamba-1 mixer (the JAX package has none; ``JambaMambaMixer`` of
AI21's Jamba) runs the same recurrence with a dt of its own per channel:
``x_proj`` gives (dt [dt_rank], B, C), each through an RMSNorm of its own,
and delta = softplus(``dt_proj`` dt + ``dt_bias``) [di]; its depthwise
convolution has a bias; no projection has one. Its prompt runs through
the same scan (the kernel reads its delta per channel, hymba's with
channel stride 0) and its token through the same one-position step as
hymba's, in fp32; its convolution sums in fp32. Under a
``torch.profiler`` session a prompt's scan, either version, is the span
``repro_torch.ssm.scan`` (``serving.tracing.span``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, rms_norm
from repro_torch.parallel.sharding import constrain, current_mesh, shard_map
from repro_torch.serving.tracing import span

f32 = torch.float32
CHUNK = 256


def init_ssm(gen: torch.Generator, cfg: ModelConfig, *, device
             ) -> Dict[str, torch.Tensor]:
    """One layer's SSM parameters with the reference's distributions
    (``init_ssm``): ``in_proj``, ``x_proj`` and ``out_proj`` of std
    1/sqrt(D), a depthwise ``conv_w`` of std 0.5, all in the model dtype;
    ``dt_bias`` = 0, ``A_log`` = log(1..ds) per channel and ``D_skip`` = 1
    stay fp32 in a bf16 configuration."""
    D = cfg.d_model
    di = cfg.ssm_expand * D
    ds, dc = cfg.ssm_state, cfg.ssm_conv
    dt = cfg.tdtype
    s = 1.0 / math.sqrt(D)

    def normal(shape, std):
        if torch.device(device).type == "meta":     # shapes only, no draws
            return torch.empty(shape, dtype=dt, device=device)
        x = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return (x * std).to(dt)

    return {
        "in_proj": normal((D, 2 * di), s),
        "conv_w": normal((dc, di), 0.5),
        "x_proj": normal((di, 2 * ds + 1), s),
        "dt_bias": torch.zeros((di,), dtype=f32, device=device),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=f32, device=device)
                           )[None, :].expand(di, ds).contiguous(),
        "D_skip": torch.ones((di,), dtype=f32, device=device),
        "out_proj": normal((di, D), s),
    }


def init_mamba(gen: torch.Generator, cfg: ModelConfig, *, device
               ) -> Dict[str, torch.Tensor]:
    """One Jamba layer's Mamba-1 mixer, in the model dtype: ``in_proj``
    [D, 2 di] and ``x_proj`` [di, R + 2 ds] of std 1/sqrt(D), ``out_proj``
    [di, D] of std 1/sqrt(D L); the depthwise ``conv_w`` [K, di] and, with
    ``ssm_conv_bias``, ``conv_b`` [di], uniform in +-1/sqrt(K) (PyTorch's
    ``Conv1d`` init); ``dt_proj`` [R, di] uniform in +-1/sqrt(R) (Mamba's);
    the norms ``dt_norm`` [R], ``b_norm``/``c_norm`` [ds] at 1. In fp32:
    ``dt_bias`` [di], the inverse softplus of dt drawn log-uniform in
    [1e-3, 0.1] (Mamba's), ``A_log`` = log(1..ds) per channel, ``D_skip``
    = 1."""
    D = cfg.d_model
    di = cfg.ssm_expand * D
    ds, dc, R = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_dt_rank
    dt = cfg.tdtype
    meta = torch.device(device).type == "meta"

    def draw(shape, scale, uniform=False, dtype=dt):
        if meta:                                    # shapes only, no draws
            return torch.empty(shape, dtype=dtype, device=device)
        if uniform:
            x = torch.rand(shape, generator=gen, dtype=f32, device=device)
            x = 2.0 * x - 1.0
        else:
            x = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return (x * scale).to(dtype)

    s = 1.0 / math.sqrt(D)
    p = {"in_proj": draw((D, 2 * di), s),
         "conv_w": draw((dc, di), 1.0 / math.sqrt(dc), uniform=True),
         "x_proj": draw((di, R + 2 * ds), s),
         "dt_norm": torch.ones((R,), dtype=dt, device=device),
         "b_norm": torch.ones((ds,), dtype=dt, device=device),
         "c_norm": torch.ones((ds,), dtype=dt, device=device),
         "dt_proj": draw((R, di), 1.0 / math.sqrt(R), uniform=True)}
    if cfg.ssm_conv_bias:
        p["conv_b"] = draw((di,), 1.0 / math.sqrt(dc), uniform=True)
    u = draw((di,), 0.5, uniform=True, dtype=f32) + 0.5     # [0, 1)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))  # softplus^-1(dt0)
    p["A_log"] = torch.log(torch.arange(1, ds + 1, dtype=f32, device=device)
                           )[None, :].expand(di, ds).contiguous()
    p["D_skip"] = torch.ones((di,), dtype=f32, device=device)
    p["out_proj"] = draw((di, D), s / math.sqrt(cfg.num_layers))
    return p


def init_ssm_state(cfg: ModelConfig, batch: int, *, device
                   ) -> Dict[str, torch.Tensor]:
    """Zero state: ``h`` [B,di,ds] fp32, ``conv`` [B,K-1,di] in the model
    dtype."""
    di = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_state), dtype=f32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=cfg.tdtype, device=device)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0) at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, conv_w, conv_state, conv_b=None):
    """x: [B,S,di]; conv_w: [K,di] depthwise; conv_state: [B,K-1,di] (the
    K-1 inputs before x); conv_b: [di] or None. Returns (out [B,S,di], the
    last K-1 inputs)."""
    K = conv_w.shape[0]
    S = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)       # [B,S+K-1,di]
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(K))
    if conv_b is not None:
        out = out + conv_b
    new_state = xp[:, -(K - 1):] if K > 1 else conv_state
    return out, new_state


def _scan_chunk(a, b, h0):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over one chunk's
    positions (dim 1), by doubling: after the step of stride d each
    position holds the composition of the up to 2d steps that end at it,
    (a, b)[t] <- (a[t-d] a[t], a[t] b[t-d] + b[t]). a, b: [B,Lc,di,ds]
    fp32; h0: [B,di,ds]. Returns (h_all [B,Lc,di,ds], h_last)."""
    Lc = a.shape[1]
    d = 1
    while d < Lc:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def _project(params, xs, ds: int):
    """(B, C, delta) of the selective projection, fp32: delta =
    softplus(dt) + 1e-4. Under a mesh the projection's sum over the
    channels is completed first."""
    proj = linear(xs, params["x_proj"])                       # [...,2ds+1]
    proj = constrain(proj, "dp", *(None,) * (proj.dim() - 1))
    return (proj[..., :ds].to(f32), proj[..., ds:2 * ds].to(f32),
            softplus(proj[..., -1].to(f32)) + 1e-4)


def _scan(xf, B_ssm, C_ssm, delta, A, h):
    """The recurrence over a prompt, chunk by chunk: xf [B,S,di] fp32, B/C
    [B,S,ds], delta [B,S] (one channel shared) or [B,S,di], A [di,ds], h
    [B,di,ds]. Returns (C_t h_t [B,S,di], the last h)."""
    with span("repro_torch.ssm.scan"):
        S = xf.shape[1]
        Lc = min(CHUNK, S)
        pad = (-S) % Lc
        # a pad position: delta = 0 -> a = 1, b = 0, the state passes
        # through
        xp, Bp, Cp = (F.pad(t, (0, 0, 0, pad)) for t in (xf, B_ssm, C_ssm))
        if delta.dim() == 2:
            delta = delta[..., None]
        dp = F.pad(delta, (0, 0, 0, pad))                 # [B,Sp,1 or di]
        ys = []
        for lo in range(0, S + pad, Lc):
            dck = dp[:, lo:lo + Lc]
            a = torch.exp(dck[..., None] * A)                 # [B,Lc,di,ds]
            b = (dck * xp[:, lo:lo + Lc])[..., None] \
                * Bp[:, lo:lo + Lc, None, :]
            h_all, h = _scan_chunk(a, b, h)
            ys.append(torch.einsum("blds,bls->bld", h_all,
                                   Cp[:, lo:lo + Lc]))
        return torch.cat(ys, dim=1)[:, :S], h


def _prompt_scan(xf, B_ssm, C_ssm, delta, A, h, impl: str):
    """A prompt's recurrence, ``_scan``'s contract: under ``impl="kernel"``
    on the card the selective-scan kernel, otherwise ``_scan`` (which the
    kernel's wrapper runs on a CPU tensor too). The kernel takes dense
    rows: in an fp32 hymba, B and C are views of the projection."""
    if impl != "kernel" or not xf.is_cuda:
        return _scan(xf, B_ssm, C_ssm, delta, A, h)
    with span("repro_torch.ssm.scan"):
        return selective_scan(*(t.contiguous() for t in (xf, B_ssm, C_ssm,
                                                          delta, A, h)))


def _recur(h, delta, A, xf, B_ssm, C_ssm):
    """One position of the recurrence: h [B,di,ds], delta [B,1] (one
    channel shared) or [B,di], A [di,ds], xf [B,di], B/C [B,ds]. Returns
    (the new h, C h [B,di])."""
    a = torch.exp(delta[..., None] * A)                       # [B,di,ds]
    b = (delta * xf)[..., None] * B_ssm[:, None, :]
    h = a * h + b
    return h, torch.einsum("bds,bs->bd", h, C_ssm)


_CH = ("dp", None, "tp")                # [B,S,di]: batch dp, channels tp
_ROW = ("dp", None, None)               # [B,S,ds]


def _in_proj(params, x):
    """(xs, z) [B,S,di] of the input projection. Under a mesh the fused
    [B,S,2*di] product is split whole, then each half laid out over the
    channels."""
    xz = linear(x, params["in_proj"])
    if current_mesh() is None or not isinstance(xz, DTensor):
        return xz.chunk(2, dim=-1)
    xs, z = constrain(xz, *_ROW).chunk(2, dim=-1)
    return constrain(xs, *_CH), constrain(z, *_CH)


def ssm_apply(params, x, state, cfg: ModelConfig, impl: str = "kernel"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,S,D] -> (y [B,S,D], new state) from ``state``; ``impl`` picks
    the scan (``_prompt_scan``). Under a mesh the convolution and the scan
    run on each rank's batch and channels (``shard_map``): both are per
    channel."""
    ds = cfg.ssm_state
    dt_ = x.dtype
    xs, z = _in_proj(params, x)                               # [B,S,di]
    xs, conv_state = shard_map(
        _causal_conv, (xs, params["conv_w"], state["conv"]),
        (_CH, (None, "tp"), _CH), lambda pl: (pl[0], pl[2]))
    xs = F.silu(xs.to(f32)).to(dt_)
    B_ssm, C_ssm, delta = _project(params, xs, ds)
    A = -torch.exp(params["A_log"])                           # [di,ds]
    xf = xs.to(f32)
    y, h = shard_map(functools.partial(_prompt_scan, impl=impl),
                     (xf, B_ssm, C_ssm, delta, A, state["h"]),
                     (_CH, _ROW, _ROW, ("dp", None), ("tp", None),
                      ("dp", "tp", None)), lambda pl: (pl[0], pl[5]))
    y = y + xf * params["D_skip"]
    y = y * F.silu(z.to(f32))
    return linear(y.to(dt_), params["out_proj"]), {"h": h,
                                                   "conv": conv_state}


def ssm_step(params, x, state, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: [B,1,D] -> (y [B,1,D], new state)."""
    ds = cfg.ssm_state
    dt_ = x.dtype
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)          # [B,1,di]
    conv_w = params["conv_w"]
    K = conv_w.shape[0]
    xp = torch.cat([state["conv"].to(dt_), xs], dim=1)        # [B,K,di]
    conv_out = sum(xp[:, i] * conv_w[i] for i in range(K))[:, None]
    xs = F.silu(conv_out.to(f32)).to(dt_)
    B_ssm, C_ssm, delta = (t[:, 0] for t in _project(params, xs, ds))
    A = -torch.exp(params["A_log"])
    xf = xs.to(f32)[:, 0]                                     # [B,di]
    h, y = _recur(state["h"], delta[:, None], A, xf, B_ssm, C_ssm)
    y = y + xf * params["D_skip"]
    y = y * F.silu(z.to(f32)[:, 0])
    return (y.to(dt_) @ params["out_proj"])[:, None], {"h": h,
                                                       "conv": xp[:, 1:]}


# ---------------------------------------------------------------------------
# Jamba's Mamba-1 mixer


def _project_mamba(params, xs, cfg: ModelConfig):
    """(B, C, delta) of Mamba-1's selective projection, fp32: ``x_proj``
    splits into dt [R], B and C [ds], each RMS-normed; delta =
    softplus(``dt_proj`` dt + ``dt_bias``) [..., di]."""
    R, ds, eps = cfg.ssm_dt_rank, cfg.ssm_state, cfg.norm_eps
    dt, B_ssm, C_ssm = linear(xs, params["x_proj"]).split([R, ds, ds],
                                                         dim=-1)
    dt = rms_norm(dt, params["dt_norm"], eps)
    B_ssm = rms_norm(B_ssm, params["b_norm"], eps).to(f32)
    C_ssm = rms_norm(C_ssm, params["c_norm"], eps).to(f32)
    delta = softplus(linear(dt, params["dt_proj"]).to(f32)
                     + params["dt_bias"])
    return B_ssm, C_ssm, delta


def mamba_apply(params, x, state, cfg: ModelConfig, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Jamba's Mamba-1 mixer over a prompt from ``state``: x [B,S,D] (the
    layer's normed input) -> (y [B,S,D], the new state); ``impl`` picks
    the scan (``_prompt_scan``)."""
    dt_ = x.dtype
    xs, z = linear(x, params["in_proj"]).chunk(2, dim=-1)     # [B,S,di]
    xs, conv_state = _causal_conv(xs.to(f32), params["conv_w"],
                                  state["conv"], params.get("conv_b"))
    xs = F.silu(xs).to(dt_)
    B_ssm, C_ssm, delta = _project_mamba(params, xs, cfg)
    xf = xs.to(f32)
    y, h = _prompt_scan(xf, B_ssm, C_ssm, delta, -torch.exp(params["A_log"]),
                        state["h"], impl)
    y = (y + xf * params["D_skip"]) * F.silu(z.to(f32))
    return linear(y.to(dt_), params["out_proj"]), {
        "h": h, "conv": conv_state.to(state["conv"].dtype)}


def mamba_step(params, x, state, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token of Jamba's Mamba-1 mixer: x [B,1,D] (normed) -> (y
    [B,1,D], the new state)."""
    dt_ = x.dtype
    xs, z = linear(x, params["in_proj"]).chunk(2, dim=-1)     # [B,1,di]
    conv_w = params["conv_w"]
    xp = torch.cat([state["conv"].to(dt_), xs], dim=1)        # [B,K,di]
    conv = sum(xp[:, i].to(f32) * conv_w[i] for i in range(conv_w.shape[0]))
    if "conv_b" in params:
        conv = conv + params["conv_b"]
    xs = F.silu(conv).to(dt_)                                 # [B,di]
    B_ssm, C_ssm, delta = _project_mamba(params, xs, cfg)
    xf = xs.to(f32)
    h, y = _recur(state["h"], delta, -torch.exp(params["A_log"]), xf, B_ssm,
                  C_ssm)
    y = (y + xf * params["D_skip"]) * F.silu(z.to(f32)[:, 0])
    return linear(y.to(dt_), params["out_proj"])[:, None], {
        "h": h, "conv": xp[:, 1:]}
