"""The plain reference: the served models' forward pass in fp32 PyTorch.

It follows the configuration as its file states it (``port`` keys: a
decoder of pre-norm blocks, RMSNorm, RoPE in its half-split form,
grouped-query causal attention at 1/sqrt(dh), a SwiGLU FFN, or a
mixture of experts routed by a softmax over all experts whose top k are
renormalised, dropless; the logits of the head, or of the tied
embedding, over the first ``vocab_size`` rows). It reads the weights the
benchmark drew (bf16) and upcasts them one layer at a time, so that it
fits beside them; it imports nothing of the program.

``quant`` puts a lower precision in place of fp32 for the control: a
function applied to both operands of every projection (the attention's
softmax and the router stay in fp32).

fp32 matrix products are held to fp32: TF32 is switched off while the
reference runs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

f32 = torch.float32


@contextlib.contextmanager
def full_fp32():
    """TF32 off for the products inside (and restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), back in fp32: the control's lower precision."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(f32) * scale


def fp8_quant(x: torch.Tensor, w: torch.Tensor):
    """Both operands of ``x @ w`` in fp8: x by row, w by output column."""
    return fp8_e4m3(x, -1), fp8_e4m3(w, 0)


class Reference:
    """``logits(seqs, n_last)``: the fp32 logits of each token sequence at
    its last ``n_last[i]`` positions, layer by layer over all sequences."""

    def __init__(self, p: Dict[str, Any], params: Dict[str, Any],
                 quant: Optional[Callable] = None):
        self.p = p
        self.params = params
        self.quant = quant
        self.D = p["d_model"]
        self.H, self.Hkv = p["num_heads"], p["num_kv_heads"]
        self.dh = p.get("head_dim") or self.D // self.H
        self.V = p["vocab_size"]
        self.eps = p.get("norm_eps", 1e-6)
        self.theta = p.get("rope_theta", 10_000.0)
        self.moe = p.get("moe")

    # -- pieces ---------------------------------------------------------

    def linear(self, x, w):
        if self.quant is not None:
            x, w = self.quant(x, w)
        return x @ w

    def rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w

    def rope(self, x, pos):
        dh = x.shape[-1]
        inv = 1.0 / (self.theta ** (torch.arange(0, dh, 2, dtype=f32,
                                                 device=x.device) / dh))
        ang = pos[:, None].to(f32) * inv                   # [S, dh/2]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, x, w):
        S = x.shape[0]
        H, Hkv, dh = self.H, self.Hkv, self.dh
        pos = torch.arange(S, device=x.device)
        q = self.linear(x, w["wq"].reshape(self.D, -1)).view(S, H, dh)
        k = self.linear(x, w["wk"].reshape(self.D, -1)).view(S, Hkv, dh)
        v = self.linear(x, w["wv"].reshape(self.D, -1)).view(S, Hkv, dh)
        q, k = self.rope(q, pos), self.rope(k, pos)
        g = H // Hkv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
        return self.linear(o.reshape(S, H * dh), w["wo"].reshape(H * dh,
                                                                 self.D))

    def ffn(self, x, w):
        if self.moe is None:
            h = F.silu(self.linear(x, w["wi_gate"])) * self.linear(
                x, w["wi_up"])
            return self.linear(h, w["wo_ffn"])
        m = w["moe"]
        k = self.moe["top_k"]
        probs = torch.softmax(x @ m["router"], dim=-1)
        top_p, top_i = probs.topk(k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        y = torch.zeros_like(x)
        for e in range(m["wg"].shape[0]):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            h = x[rows]
            h = F.silu(self.linear(h, m["wg"][e])) * self.linear(h,
                                                                  m["wu"][e])
            y.index_add_(0, rows,
                         self.linear(h, m["wd"][e]) * top_p[rows, slot, None])
        return y

    # -- the forward ----------------------------------------------------

    @staticmethod
    def _fp32(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(f32)
        return {k: Reference._fp32(v) for k, v in tree.items()}

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               n_last: Sequence[int]) -> List[torch.Tensor]:
        """seqs: 1-D token tensors on the weights' device. Returns, for
        each, fp32 logits [n_last, vocab_size]."""
        P = self.params
        with full_fp32():
            emb = P["embed"]
            xs = [emb[s.long()].to(f32) for s in seqs]
            for blk in P["blocks"]:
                w = self._fp32(blk)
                for i, x in enumerate(xs):
                    x = x + self.attention(self.rms(x, w["attn_norm"]), w)
                    xs[i] = x + self.ffn(self.rms(x, w["ffn_norm"]), w)
                del w
            head = (emb[:self.V].T if self.p.get("tie_embeddings") else
                    P["lm_head"][:, :self.V]).to(f32)
            fn = P["final_norm"].to(f32)
            out = []
            for x, n in zip(xs, n_last):
                out.append(self.linear(self.rms(x[-n:], fn), head))
            return out
