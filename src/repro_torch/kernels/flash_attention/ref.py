"""Plain PyTorch version of the flash-attention kernel: the CPU path of
``ops.flash_attention`` and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        window: int = 0):
    """q: [B,Sq,H,dh]; k, v: [B,Skv,Hkv,dh]; H % Hkv == 0 (query head h
    reads KV head h // (H/Hkv)). fp32 math, output in q.dtype. Causal rows
    sit at absolute positions q_offset + i. ``window`` > 0 (causal only)
    bands them: the row at position pos sees key column col iff
    pos - window < col <= pos, the reference's
    ``sliding_window_attention_xla``. A fully masked row gives 0, as the
    kernels do (finite NEG_INF and the m > 0.5*NEG_INF guard)."""
    if window and not causal:
        raise ValueError("a sliding window needs causal attention")
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    if causal:
        rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        s.masked_fill_(cols > rows, NEG_INF)
        if window:
            s.masked_fill_(cols <= rows - window, NEG_INF)
    # the score tensor is rewritten in place from here on: at llava's
    # 56 heads and 3,392 positions it alone is 2.4 GiB beside 64 GiB of
    # weights
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_().masked_fill_(m <= 0.5 * NEG_INF, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.div_(l), v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)
