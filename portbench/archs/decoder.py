"""The decoder: pre-norm blocks of grouped-query attention and a SwiGLU
or mixture-of-experts FFN in every layer, as the port's ``attn`` family
runs them (phi3-medium-14b, granite-moe-1b-a400m). A configuration whose
file names no ``arch`` has this one.

- ``layout(p)``: the weights in the port's parameter layout (``embed``
  [Vp, D], ``blocks`` with ``wq`` [D, H, dh], ``wk``/``wv`` [D, Hkv, dh],
  ``wo`` [H, dh, D], the dense SwiGLU ``wi_gate``/``wi_up`` [D, F] and
  ``wo_ffn`` [F, D] or the MoE FFN's ``moe`` = ``router`` [D, E] fp32,
  ``wg``/``wu`` [E, D, F], ``wd`` [E, F, D]; norms; ``lm_head`` [D, Vp]
  unless the embedding is tied).
- ``Reference``: the plain forward in fp32 PyTorch, as the configuration's
  file states it (``port`` keys): RMSNorm, RoPE in its half-split form,
  grouped-query causal attention at 1/sqrt(dh), a SwiGLU FFN, or a mixture
  of experts routed by a softmax over all experts whose top k are
  renormalised, dropless; the logits of the head, or of the tied
  embedding, over the first ``vocab_size`` rows. It reads the weights the
  benchmark drew (bf16) and upcasts them one layer at a time, so that it
  fits beside them; it imports nothing of the program. ``quant`` puts a
  lower precision in place of fp32 for the control: a function applied to
  both operands of every projection (the attention's softmax and the
  router stay in fp32).
- ``prefill_flops``, ``decode_flops``: model FLOPs (``pbench.counts``
  says what they count); ``attn_layers``: the layers that run the
  attention kernels, every one.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pbench import counts
from pbench.reference import f32, full_fp32


def layout(p: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf for the port keys ``p``, in draw
    order; init is ``in``, ``out``, ``embed``, ``router`` or ``ones``."""
    D, L = p["d_model"], p["num_layers"]
    H, Hkv = p["num_heads"], p["num_kv_heads"]
    dh = p.get("head_dim") or D // H
    V = p["vocab_size"] + p.get("vocab_pad", 0)
    out = [(("embed",), (V, D), "embed"), (("final_norm",), (D,), "ones")]
    if not p.get("tie_embeddings", False):
        out.append((("lm_head",), (D, V), "in"))
    for i in range(L):
        b = ("blocks", i)
        out += [(b + ("attn_norm",), (D,), "ones"),
                (b + ("wq",), (D, H, dh), "in"),
                (b + ("wk",), (D, Hkv, dh), "in"),
                (b + ("wv",), (D, Hkv, dh), "in"),
                (b + ("wo",), (H, dh, D), "out"),
                (b + ("ffn_norm",), (D,), "ones")]
        moe = p.get("moe")
        if moe:
            E, F = moe["num_experts"], moe["d_ff_expert"]
            out += [(b + ("moe", "router"), (D, E), "router"),
                    (b + ("moe", "wg"), (E, D, F), "in"),
                    (b + ("moe", "wu"), (E, D, F), "in"),
                    (b + ("moe", "wd"), (E, F, D), "out")]
        else:
            F = p["d_ff"]
            out += [(b + ("wi_gate",), (D, F), "in"),
                    (b + ("wi_up",), (D, F), "in"),
                    (b + ("wo_ffn",), (F, D), "out")]
    return out


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


def layer_weights_active(p: Dict[str, Any]) -> int:
    """Projection weights one token passes through in one layer."""
    d = counts.dims(p)
    D, H, Hkv, dh = d["D"], d["H"], d["Hkv"], d["dh"]
    attn = D * H * dh + 2 * D * Hkv * dh + H * dh * D
    moe = p.get("moe")
    if moe:
        ffn = D * moe["num_experts"] + moe["top_k"] * 3 * D * moe[
            "d_ff_expert"]
    else:
        ffn = 3 * D * p["d_ff"]
    return attn + ffn


def prefill_flops(p, S: int) -> float:
    """Model FLOPs of one prompt's prefill: the layers over S tokens, the
    head at the last position, causal attention."""
    d = counts.dims(p)
    return (2.0 * S * d["L"] * layer_weights_active(p)
            + 2.0 * d["D"] * d["V"] + d["L"] * counts.attn_prefill_flops(p, S))


def decode_flops(p, active: int, ctx_sum: int) -> float:
    """Model FLOPs of one decode step over ``active`` requests whose
    attended positions sum to ``ctx_sum``."""
    d = counts.dims(p)
    return (2.0 * active * (d["L"] * layer_weights_active(p)
                            + d["D"] * d["V"])
            + d["L"] * counts.attn_decode_flops(p, ctx_sum))


def attn_layers(p: Dict[str, Any]) -> int:
    """Layers that run the flash kernel in a prefill and the paged kernel
    in a decode step."""
    return p["num_layers"]
