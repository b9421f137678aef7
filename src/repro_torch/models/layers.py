"""Core layers: RMS norm, RoPE, SwiGLU and GQA head plumbing.

PyTorch counterparts of ``repro.models.layers``. Attention itself lives in
``repro_torch.kernels`` (hand-written CUDA kernels, each beside its plain
PyTorch version); the model picks one per call with ``impl``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

f32 = torch.float32
# finite, as in the reference: a fully masked row gives exp(NEG_INF - NEG_INF)
# = 1 (then zeroed by the m > 0.5*NEG_INF guard) instead of NaN
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(f32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(f32)).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=f32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0):
    """x: [..., S, H, dh]; positions: broadcastable to [..., S]. The
    half-split form: the first and second halves of dh rotate as pairs."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)             # [dh/2]
    angles = positions[..., None].to(f32) * freqs             # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def expand_kv(k: torch.Tensor, head_map: torch.Tensor):
    """[B,S,Hkv,dh] -> [B,S,Hp,dh] via an explicit q-head -> kv-head map
    (padded q heads map to kv head 0; their output is masked later)."""
    if head_map.shape[0] == k.shape[2]:
        return k
    return torch.index_select(k, 2, head_map)


def swiglu(x, wi_gate, wi_up, wo):
    h = x @ wi_gate
    u = x @ wi_up
    h = F.silu(h.to(f32)).to(x.dtype) * u
    return h @ wo
