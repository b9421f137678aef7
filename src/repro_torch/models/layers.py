"""Core layers: RMS norm, RoPE, SwiGLU, GQA head plumbing and the
reference's attention functions.

PyTorch counterparts of ``repro.models.layers``. Serving attention lives in
``repro_torch.kernels`` (hand-written CUDA kernels, each beside its plain
PyTorch version); the model picks one per call with ``impl``. Under a
device mesh (``parallel.sharding.use_mesh``) the GQA expansion and the
SwiGLU constrain their outputs to the reference's layouts. The
attention functions here are the reference's XLA ones in plain,
differentiable PyTorch — the training forward's, since no kernel has a
backward: ``causal_attention_xla`` (exact block-causal online softmax,
recursing on the causal triangle so fully masked blocks cost nothing),
``chunked_prefill_attention_xla``, ``sliding_window_attention_xla``,
``dense_attention`` (the naive oracle) and ``decode_attention_xla``. Each
takes q, k, v [B,S,H,dh] with K/V already expanded to the query heads and
computes in fp32 as the reference's ``preferred_element_type=f32``
einsums do: p is rounded to v's dtype before p @ v, as there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import (constrain, current_mesh,
                                           mesh_dims, pin, placements_for)

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
    out = torch.index_select(k, 2, head_map)
    return constrain(out, "dp", None, "tp", None)


def linear(x, w):
    """``x @ w``. Under a mesh the product's gradient comes back laid out
    as the product is (``pin``): left free, DTensor's backward may split
    the sequence over the model axis, a layout the product's
    ``[B*S, D]`` view cannot take."""
    return pin(x @ w)


def split_heads(t, H: int, dh: int):
    """[..., H*dh] -> [..., H, dh] (the leading dim the batch). Under a
    mesh the flat dim is first laid out in whole heads (over tp where H
    divides it, else replicated): DTensor cannot split a dim sharded
    across a head."""
    lead = t.shape[:-1]
    if current_mesh() is not None and isinstance(t, DTensor):
        mid = (None,) * (len(lead) - 1)
        whole = mesh_dims(current_mesh(), placements_for(
            tuple(lead) + (H, dh), "dp", *mid, "tp", None), len(lead))
        t = constrain(t, "dp", *mid, "tp" if whole else None)
        # (pinned: the gradient must come back in whole heads too)
        return pin(t.reshape(tuple(lead) + (H, dh)))
    return t.reshape(tuple(lead) + (H, dh))


def swiglu(x, wi_gate, wi_up, wo):
    h = linear(x, wi_gate)
    u = linear(x, wi_up)
    h = F.silu(h.to(f32)).to(x.dtype) * u
    h = constrain(h, "dp", None, "tp")
    return constrain(linear(h, wo), "dp", None, None)


def repeat_kv(k: torch.Tensor, num_heads: int):
    """[B,S,Hkv,dh] -> [B,S,H,dh], each KV head repeated for its group."""
    Hkv = k.shape[2]
    if Hkv == num_heads:
        return k
    k = torch.repeat_interleave(k, num_heads // Hkv, dim=2)
    return constrain(k, "dp", None, "tp", None)


# ---------------------------------------------------------------------------
# Attention building blocks (online softmax over KV ranges)


def _masked(s, mask):
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _pv(p, v):
    """p [B,H,Sq,Sk] fp32 @ v [B,Sk,H,d] -> [B,Sq,H,d] fp32, p rounded to
    v's dtype first (the reference's ``p.astype(v.dtype)``)."""
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def _attend_block(q, k, v, mask=None, scale: float = 1.0):
    """One dense block. q [B,Sq,H,d], k/v [B,Sk,H,d] -> (o, m, l) fp32:
    o unnormalised (the caller divides by l); a fully masked row gives
    (0, NEG_INF, 0)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = _masked(s, mask)
    m = s.amax(dim=-1)                                        # [B,H,Sq]
    p = torch.exp(s - m[..., None])
    p = torch.where((m > 0.5 * NEG_INF)[..., None], p, torch.zeros_like(p))
    return _pv(p, v), m, p.sum(dim=-1)


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two online-softmax partials over the same queries."""
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o, m, l1 * a1 + l2 * a2


def _full_blocked(q, k, v, scale: float, block: int):
    """Rectangular (no-mask) attention, KV block by KV block."""
    B, Sk, H, d = k.shape
    if Sk % block != 0 or Sk <= block:
        return _attend_block(q, k, v, scale=scale)
    Sq = q.shape[1]
    o = q.new_zeros((B, Sq, H, d), dtype=f32)
    m = q.new_full((B, H, Sq), NEG_INF, dtype=f32)
    l = q.new_zeros((B, H, Sq), dtype=f32)
    for lo in range(0, Sk, block):
        ob, mb, lb = _attend_block(q, k[:, lo:lo + block], v[:, lo:lo + block],
                                   scale=scale)
        o, m, l = _merge(o, m, l, ob, mb, lb)
    return o, m, l


def _causal_rec(q, k, v, scale: float, block: int):
    """Recursive causal attention, len(q) == len(k):
    causal(S) = [causal(S/2) top-left] + [full(q_hi, k_lo) merged with
    causal(S/2) bottom-right]."""
    S = q.shape[1]
    if S <= block:
        pos = torch.arange(S, device=q.device)
        mask = (pos[:, None] >= pos[None, :])[None, None]
        return _attend_block(q, k, v, mask=mask, scale=scale)
    half = S // 2
    o_tl, m_tl, l_tl = _causal_rec(q[:, :half], k[:, :half], v[:, :half],
                                   scale, block)
    o_bl, m_bl, l_bl = _full_blocked(q[:, half:], k[:, :half], v[:, :half],
                                     scale, block)
    o_br, m_br, l_br = _causal_rec(q[:, half:], k[:, half:], v[:, half:],
                                   scale, block)
    o_b, m_b, l_b = _merge(o_bl, m_bl, l_bl, o_br, m_br, l_br)
    return (torch.cat([o_tl, o_b], dim=1), torch.cat([m_tl, m_b], dim=2),
            torch.cat([l_tl, l_b], dim=2))


def _normalise(o, l, dtype):
    return (o / l.clamp(min=1e-30).transpose(1, 2)[..., None]).to(dtype)


def causal_attention_xla(q, k, v, *, scale: Optional[float] = None,
                         block: int = 1024):
    """Exact causal attention, flash-style. q, k, v: [B,S,H,dh]."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    o, _, l = _causal_rec(q, k, v, scale, block)
    return _normalise(o, l, q.dtype)


def chunked_prefill_attention_xla(q, k_full, v_full, kv_offset: int, *,
                                  scale: Optional[float] = None,
                                  block: int = 1024):
    """Attention for a prefill chunk: q is tokens [off, off+Sq), k/v_full
    the cache prefix [0, off+Sq). The prefix is rectangular (no mask), the
    chunk itself causal."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    Sq, off = q.shape[1], kv_offset
    o, m, l = _causal_rec(q, k_full[:, off:off + Sq], v_full[:, off:off + Sq],
                          scale, block)
    if off > 0:
        o_p, m_p, l_p = _full_blocked(q, k_full[:, :off], v_full[:, :off],
                                      scale, block)
        o, m, l = _merge(o_p, m_p, l_p, o, m, l)
    return _normalise(o, l, q.dtype)


def sliding_window_attention_xla(q, k, v, window: int, *,
                                 scale: Optional[float] = None):
    """Banded causal attention: each token attends to the previous
    ``window`` tokens, itself included. Chunks of W rows, each against its
    own chunk and the one before (zero-padded to whole chunks)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    B, S, H, d = q.shape
    W = window
    if S <= W:
        return causal_attention_xla(q, k, v, scale=scale, block=max(128, W))
    pad = (-S) % W
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nc = q.shape[1] // W
    qc, kc, vc = (t.reshape(B, nc, W, H, d) for t in (q, k, v))
    k2 = torch.cat([F.pad(kc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), kc], dim=2)
    v2 = torch.cat([F.pad(vc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), vc], dim=2)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qc.float(), k2.float()) * scale
    qpos = torch.arange(W, device=q.device)[:, None]
    kpos = torch.arange(2 * W, device=q.device)[None, :] - W
    band = (kpos <= qpos) & (kpos > qpos - W)                  # [W,2W]
    first = torch.arange(nc, device=q.device) == 0
    valid = band[None, None, None] & ~(first[None, :, None, None, None]
                                       & (kpos < 0)[None, None, None])
    p = torch.softmax(_masked(s, valid), dim=-1)
    o = torch.einsum("bnhqk,bnkhd->bnqhd", p.to(v2.dtype).float(),
                     v2.float())
    return o.reshape(B, nc * W, H, d)[:, :S].to(q.dtype)


def dense_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, window: int = 0,
                    kv_offset: int = 0):
    """Naive masked attention: the oracle for tests."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = torch.softmax(_masked(s, mask[None, None]), dim=-1)
    return _pv(p, v).to(q.dtype)


def decode_attention_xla(q, k_cache, v_cache, pos, *,
                         scale: Optional[float] = None, window: int = 0):
    """Single-token decode: q [B,1,H,dh] against caches [B,Smax,H,dh];
    the rows <= pos (and > pos - window) are valid."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    Smax = k_cache.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    kpos = torch.arange(Smax, device=q.device)[None, None, None, :]
    mask = kpos <= pos
    if window:
        mask &= kpos > pos - window
    p = torch.softmax(_masked(s, mask), dim=-1)
    return _pv(p, v_cache).to(q.dtype)
