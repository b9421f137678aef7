"""Plain PyTorch versions of the RWKV-6 WKV recurrence.

All three take the reference model's layout: r, k, v, logw ``[B,S,H,N]``
(or ``[B,H,N]`` for one token), u ``[H,N]``, the state ``[B,H,N,N]`` in
fp32, and return y in fp32 and the new state in fp32:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,    w_t = exp(logw_t) <= 1
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

- ``wkv_ref``: the sequential, token-by-token recurrence, ported from
  ``repro.kernels.rwkv6.ref`` (there in the kernel's ``[BH,S,N]`` layout).
  It is the oracle the CUDA kernel is held against.
- ``wkv_chunked``: the chunked matrix form, ported from
  ``repro.models.rwkv6.wkv_chunked``; every exponent is <= 0. It is what
  the plain model path runs at prefill and what the kernel wrapper runs on
  a CPU tensor.
- ``wkv_step``: one token, ported from ``repro.models.rwkv6.wkv_step``;
  the plain model path's decode step.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def wkv_ref(r, k, v, logw, u, state0):
    """Sequential recurrence. r,k,v,logw: [B,S,H,N]; u: [H,N]; state0:
    [B,H,N,N]. Returns (y [B,S,H,N] fp32, state [B,H,N,N] fp32)."""
    r, k, v, logw = (a.to(f32) for a in (r, k, v, logw))
    u = u.to(f32)
    S = state0.to(f32).clone()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # [B,H,N,N]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               S + u[..., None] * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 32):
    """Chunked form. r,k,v,logw: [B,S,H,N]; u: [H,N]; state: [B,H,N,N].
    Returns (y [B,S,H,N] fp32, new state [B,H,N,N] fp32). Exact: every
    exp() argument is <= 0 (cumulative log-decays never increase). A
    ragged tail is padded with k = 0 and logw = 0, which leaves the state
    untouched."""
    B, S, H, N = r.shape
    Lc = min(chunk, S)
    pad = (-S) % Lc
    r, k, v, logw = (a.to(f32) for a in (r, k, v, logw))
    u = u.to(f32)
    if pad:
        z = r.new_zeros((B, pad, H, N))
        r, k, v, logw = (torch.cat([a, z], dim=1) for a in (r, k, v, logw))
    nc = r.shape[1] // Lc
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=r.device), diagonal=-1)  # i < j
    S0 = state.to(f32)
    ys = []
    for c in range(nc):
        sl = slice(c * Lc, (c + 1) * Lc)
        r_c, k_c, v_c, lw_c = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cw = torch.cumsum(lw_c, dim=1)                    # inclusive, <= 0
        cw_prev = cw - lw_c                               # cw_{j-1}
        y_inter = torch.einsum("blhn,bhnm->blhm", r_c * torch.exp(cw_prev),
                               S0)
        # min(diff, 0) as jnp.minimum: a tie (diff == 0) splits the
        # gradient evenly, where clamp would pass all of it
        diff = torch.minimum(cw_prev[:, :, None] - cw[:, None, :],
                             torch.zeros((), dtype=f32, device=r.device))
        a = torch.exp(diff) * tri[None, :, :, None, None]  # [B,j,i,H,N]
        s = torch.einsum("bjhn,bjihn,bihn->bjih", r_c, a, k_c)
        y_intra = torch.einsum("bjih,bihm->bjhm", s, v_c)
        coef = torch.einsum("blhn,hn,blhn->blh", r_c, u, k_c)
        ys.append(y_inter + y_intra + coef[..., None] * v_c)
        last = cw[:, -1]                                  # [B,H,N]
        kd = k_c * torch.exp(last[:, None] - cw)
        S0 = torch.exp(last)[..., None] * S0 + torch.einsum(
            "blhn,blhm->bhnm", kd, v_c)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, S0


def wkv_step(r, k, v, logw, u, state):
    """One token. r,k,v,logw: [B,H,N]; u: [H,N]; state: [B,H,N,N].
    Returns (y [B,H,N] fp32, new state)."""
    r, k, v, logw = (a.to(f32) for a in (r, k, v, logw))
    kv = k[..., :, None] * v[..., None, :]                # [B,H,N,N]
    y = torch.einsum("bhn,bhnm->bhm", r, state + u.to(f32)[..., None] * kv)
    return y, torch.exp(logw)[..., None] * state + kv
