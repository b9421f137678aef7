"""Plain PyTorch versions of the two decode kernels: the CPU paths of
``ops.decode_attention`` and ``ops.decode_attention_paged`` and the
oracles the CUDA kernels are held against.

- ``decode_attention_ref`` (dense cache): one softmax over each row's
  live columns, as the JAX package's ``decode_attention_ref``.
- ``paged_decode_partials_ref`` (block pool): the paged kernel's own
  outputs — fp32 split partials (o, m, l), one split per
  ``pages_per_split`` table entries — so the CPU path runs the same split
  algebra and the same merge as the card.
- ``dense_decode_partials_ref`` (dense cache): the dense kernel's
  partials, one split per ``split_tokens`` cache rows, the last cut at
  Smax."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _split_partials(qg, k, v, valid):
    """Online-softmax partials of qg [B,Hkv,G,dh] over k/v [B,S,T,Hkv,dh]
    with valid [B,S,T]: o [B,Hkv,S,G,dh] (unnormalised), m and l
    [B,Hkv,S,G], all fp32; a split with no valid row gives (0, NEG_INF,
    0)."""
    dh = qg.shape[-1]
    s = torch.einsum("bhgd,bsthd->bhsgt", qg.float(), k.float()) / math.sqrt(
        dh)
    s = torch.where(valid[:, None, :, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > 0.5 * NEG_INF)[..., None], p, torch.zeros_like(p))
    o = torch.einsum("bhsgt,bsthd->bhsgd", p, v.float())
    return o, m, p.sum(dim=-1)


def paged_decode_partials_ref(qg, pool_k, pool_v, tables, lengths, *,
                              pages_per_split: int):
    """qg: [B,Hkv,G,dh]; pools: [N,Bs,Hkv,dh]; tables: [B,nb] block ids in
    sequence order; lengths: [B] valid tokens. Returns o [B,Hkv,S,G,dh]
    (unnormalised), m and l [B,Hkv,S,G], all fp32, with S splits. Columns
    at or past a sequence's length get p = 0 before p @ v; a split with no
    live column gives (0, NEG_INF, 0)."""
    B, Hkv, G, dh = qg.shape
    Bs = pool_k.shape[1]
    nb = tables.shape[1]
    S = -(-nb // pages_per_split)
    T = pages_per_split * Bs
    tbl = F.pad(tables.long(), (0, S * pages_per_split - nb))  # -> trash 0
    k = pool_k[tbl].reshape(B, S, T, Hkv, dh)
    v = pool_v[tbl].reshape(B, S, T, Hkv, dh)
    tok = torch.arange(S * T, device=qg.device).reshape(S, T)
    valid = tok[None] < lengths.to(qg.device).long()[:, None, None]
    return _split_partials(qg, k, v, valid)


def dense_decode_partials_ref(qg, k_cache, v_cache, lengths, *,
                              split_tokens: int):
    """qg: [B,Hkv,G,dh]; caches: [B,Smax,Hkv,dh]; lengths: [B] live rows
    (clamped to Smax). Returns o [B,Hkv,S,G,dh] (unnormalised), m and l
    [B,Hkv,S,G], all fp32, with S = ceil(Smax / split_tokens) splits of
    split_tokens rows, the last cut at Smax. Rows at or past a length get
    p = 0; a split with no live row gives (0, NEG_INF, 0)."""
    B, Smax, Hkv, dh = k_cache.shape
    T = split_tokens
    S = -(-Smax // T)
    pad = (0, 0, 0, 0, 0, S * T - Smax)          # rows Smax.. are dead
    k = F.pad(k_cache, pad).reshape(B, S, T, Hkv, dh)
    v = F.pad(v_cache, pad).reshape(B, S, T, Hkv, dh)
    tok = torch.arange(S * T, device=qg.device).reshape(S, T)
    valid = tok[None] < lengths.to(qg.device).long()[:, None, None]
    return _split_partials(qg, k, v, valid)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: [B,H,dh]; caches: [B,Smax,Hkv,dh]; lengths: [B] (query head h
    reads KV head h // (H/Hkv)). Row b attends over its first lengths[b]
    cache rows (all Smax when lengths[b] >= Smax). fp32 math, output in
    q.dtype; a row with length 0 gives 0, as the kernel's finite NEG_INF
    and m > 0.5*NEG_INF guard do."""
    B, H, dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(dh)
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])             # [B,Smax]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > 0.5 * NEG_INF, p, torch.zeros_like(p))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, H, dh).to(q.dtype)
