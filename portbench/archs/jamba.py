"""AI21's Jamba (``model_type: jamba``): layers of two mixers and two
FFNs. Attention (grouped-query, no position encoding) in the layers
``i % attn_layer_period == attn_layer_offset``, a Mamba-1 mixer in the
others; a mixture of experts in the layers ``i % expert_layer_period ==
expert_layer_offset``, a dense SwiGLU in the others. The port's ``jamba``
block runs it (``repro_torch.models``); this file holds what the benchmark
knows of it, independent of the program:

- ``layout(p)``: the weights in the port's parameter layout. An attention
  layer: ``attn_norm``, ``wq`` [D, H, dh], ``wk``/``wv`` [D, Hkv, dh],
  ``wo`` [H, dh, D]. A Mamba-1 layer: ``ssm_norm`` and ``ssm`` =
  ``in_proj`` [D, 2 di], ``conv_w`` [K, di] and ``conv_b`` [di],
  ``x_proj`` [di, R + 2 ds], the norms ``dt_norm`` [R], ``b_norm``,
  ``c_norm`` [ds], ``dt_proj`` [R, di], ``dt_bias`` [di], ``A_log`` [di,
  ds], ``D_skip`` [di], ``out_proj`` [di, D]. Then ``ffn_norm`` and the
  MoE FFN's ``moe`` = ``router`` [D, E_routed] fp32 and the held experts'
  ``wg``/``wu`` [E_held, D, F], ``wd`` [E_held, F, D], or the dense
  ``wi_gate``/``wi_up`` [D, F], ``wo_ffn`` [F, D]. The shared inits, and
  of its own: the convolution's weight and bias uniform in +-1/sqrt(K)
  (PyTorch's ``Conv1d`` init), ``A_log`` = log(1..ds) per channel and
  ``D_skip`` = 1, ``dt_bias`` the inverse softplus of dt drawn
  log-uniform in [0.001, 0.1] (Mamba's init), all three fp32.
- ``Reference``: the plain fp32 forward, as Jamba defines it: pre-norm
  residual layers (RMSNorm); causal grouped-query attention at
  1/sqrt(dh) with no position encoding; the Mamba-1 mixer: ``in_proj``
  into x and the gate z, the causal depthwise convolution with its bias
  and SiLU, ``x_proj`` into (dt, B, C) each through its RMSNorm, delta =
  softplus(``dt_proj`` dt + ``dt_bias``) per channel, and the recurrence
  h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t, y_t = C_t h_t + D x_t run
  position by position (batched over the sequences), times SiLU(z),
  through ``out_proj``; the MoE FFN: a softmax over all the router's
  experts, the top k taken as they are (Jamba's; renormalised only where
  the configuration's ``renormalize`` is not false), summed over the
  experts this card holds (what the others would add is left out, as
  the program leaves it out); a dense SwiGLU; the head. It reads the
  weights the benchmark drew and upcasts them one layer at a time, with
  TF32 off; it imports nothing of the program. ``quant`` puts a lower
  precision in place of fp32 for the control, on both operands of every
  projection (the router, the attention's softmax and the recurrence
  stay in fp32).
- ``prefill_flops``, ``decode_flops``: model FLOPs: the projections a
  token passes through (the top-k experts at this card's share of them,
  k x E_held / E_routed), the convolution, the recurrence (9 di ds a
  token in a Mamba-1 layer), causal attention in the attention layers and
  the head where logits are taken. ``attn_layers``: the attention layers,
  which run the flash and paged kernels.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pbench import counts
from pbench.reference import f32, full_fp32

SCAN_FLOPS = 9          # a token's recurrence in a Mamba-1 layer, per di ds
_CHUNK = 64             # positions whose coefficients are made at once


def _attends(p, i: int) -> bool:
    return i % p["attn_layer_period"] == p["attn_layer_offset"]


def _has_experts(p, i: int) -> bool:
    return i % p["expert_layer_period"] == p["expert_layer_offset"]


def _routed(m) -> int:
    """The experts the router routes over (the held ones where unset)."""
    return m.get("router_experts") or m["num_experts"]


def _mamba_dims(p):
    return (p["ssm_expand"] * p["d_model"], p["ssm_state"], p["ssm_conv"],
            p["ssm_dt_rank"])


def _uniform(bound: float):
    def init(shape, gen):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return ((2.0 * u - 1.0) * bound).to(torch.bfloat16)
    return init


def _dt_bias(shape, gen):
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand(shape, generator=gen, device=gen.device)
                   * (hi - lo) + lo)
    return dt + torch.log(-torch.expm1(-dt))        # softplus^-1(dt)


def _a_log(shape, gen):
    di, ds = shape
    return torch.log(torch.arange(1, ds + 1, dtype=f32, device=gen.device)
                     )[None, :].expand(di, ds).contiguous()


def _ones_f32(shape, gen):
    return torch.ones(shape, dtype=f32, device=gen.device)


def layout(p: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...], Any]]:
    """(path, shape, init) of every leaf for the port keys ``p``, in draw
    order."""
    D, L, V = p["d_model"], p["num_layers"], p["vocab_size"]
    H, Hkv = p["num_heads"], p["num_kv_heads"]
    dh = p.get("head_dim") or D // H
    di, ds, K, R = _mamba_dims(p)
    out = [(("embed",), (V, D), "embed"), (("final_norm",), (D,), "ones"),
           (("lm_head",), (D, V), "in")]
    for i in range(L):
        b = ("blocks", i)
        if _attends(p, i):
            out += [(b + ("attn_norm",), (D,), "ones"),
                    (b + ("wq",), (D, H, dh), "in"),
                    (b + ("wk",), (D, Hkv, dh), "in"),
                    (b + ("wv",), (D, Hkv, dh), "in"),
                    (b + ("wo",), (H, dh, D), "out")]
        else:
            s = b + ("ssm",)
            out += [(b + ("ssm_norm",), (D,), "ones"),
                    (s + ("in_proj",), (D, 2 * di), "in"),
                    (s + ("conv_w",), (K, di), _uniform(K ** -0.5))]
            if p.get("ssm_conv_bias"):
                out.append((s + ("conv_b",), (di,), _uniform(K ** -0.5)))
            out += [(s + ("x_proj",), (di, R + 2 * ds), "in"),
                    (s + ("dt_norm",), (R,), "ones"),
                    (s + ("b_norm",), (ds,), "ones"),
                    (s + ("c_norm",), (ds,), "ones"),
                    (s + ("dt_proj",), (R, di), "in"),
                    (s + ("dt_bias",), (di,), _dt_bias),
                    (s + ("A_log",), (di, ds), _a_log),
                    (s + ("D_skip",), (di,), _ones_f32),
                    (s + ("out_proj",), (di, D), "out")]
        out.append((b + ("ffn_norm",), (D,), "ones"))
        if _has_experts(p, i):
            m = p["moe"]
            E, Fe = m["num_experts"], m["d_ff_expert"]
            out += [(b + ("moe", "router"), (D, _routed(m)), "router"),
                    (b + ("moe", "wg"), (E, D, Fe), "in"),
                    (b + ("moe", "wu"), (E, D, Fe), "in"),
                    (b + ("moe", "wd"), (E, Fe, D), "out")]
        else:
            Fd = p["d_ff"]
            out += [(b + ("wi_gate",), (D, Fd), "in"),
                    (b + ("wi_up",), (D, Fd), "in"),
                    (b + ("wo_ffn",), (Fd, D), "out")]
    return out


class Reference:
    """``logits(seqs, n_last)``: the fp32 logits of each token sequence at
    its last ``n_last[i]`` positions, layer by layer over all sequences."""

    def __init__(self, p: Dict[str, Any], params: Dict[str, Any],
                 quant: Optional[Callable] = None):
        if p.get("rope", True):
            raise ValueError("Jamba's attention has no position encoding")
        self.p = p
        self.params = params
        self.quant = quant
        self.D = p["d_model"]
        self.H, self.Hkv = p["num_heads"], p["num_kv_heads"]
        self.dh = p.get("head_dim") or self.D // self.H
        self.V = p["vocab_size"]
        self.eps = p.get("norm_eps", 1e-6)
        self.moe = p["moe"]

    # -- pieces ---------------------------------------------------------

    def linear(self, x, w):
        if self.quant is not None:
            x, w = self.quant(x, w)
        return x @ w

    def rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w

    def attention(self, x, w):
        S = x.shape[0]
        H, Hkv, dh = self.H, self.Hkv, self.dh
        q = self.linear(x, w["wq"].reshape(self.D, -1)).view(S, H, dh)
        k = self.linear(x, w["wk"].reshape(self.D, -1)).view(S, Hkv, dh)
        v = self.linear(x, w["wv"].reshape(self.D, -1)).view(S, Hkv, dh)
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
        return self.linear(o.reshape(S, H * dh), w["wo"].reshape(H * dh,
                                                                 self.D))

    def mamba(self, xs: List[torch.Tensor], w) -> List[torch.Tensor]:
        """The Mamba-1 mixer over each sequence (the layer's normed input)
        from a zero state; the sequences zero-padded at their ends into
        one batch (a pad position follows every real one, so none reads
        it)."""
        n = [x.shape[0] for x in xs]
        S = max(n)
        X = torch.stack([F.pad(x, (0, 0, 0, S - len(x))) for x in xs])
        di, ds, K, R = _mamba_dims(self.p)
        x, z = self.linear(X, w["in_proj"]).chunk(2, dim=-1)  # [N,S,di]
        xp = F.pad(x, (0, 0, K - 1, 0))
        x = sum(xp[:, j:j + S] * w["conv_w"][j] for j in range(K))
        x = F.silu(x + w["conv_b"] if "conv_b" in w else x)
        dt, Bm, Cm = self.linear(x, w["x_proj"]).split([R, ds, ds], dim=-1)
        dt = self.rms(dt, w["dt_norm"])
        Bm, Cm = self.rms(Bm, w["b_norm"]), self.rms(Cm, w["c_norm"])
        delta = F.softplus(self.linear(dt, w["dt_proj"]) + w["dt_bias"])
        A = -torch.exp(w["A_log"])                                # [di,ds]
        h = x.new_zeros((len(xs), di, ds))
        y = torch.empty_like(x)
        for lo in range(0, S, _CHUNK):
            hi = min(S, lo + _CHUNK)
            d = delta[:, lo:hi, :, None]
            dA = torch.exp(d * A)                                 # [N,c,di,ds]
            dBx = d * x[:, lo:hi, :, None] * Bm[:, lo:hi, None, :]
            for t in range(hi - lo):
                h = dA[:, t] * h + dBx[:, t]
                y[:, lo + t] = torch.bmm(h, Cm[:, lo + t, :, None])[..., 0]
        y = (y + x * w["D_skip"]) * F.silu(z)
        out = self.linear(y, w["out_proj"])
        return [out[i, :m] for i, m in enumerate(n)]

    def ffn(self, x, w):
        if "moe" not in w:
            h = F.silu(self.linear(x, w["wi_gate"])) * self.linear(
                x, w["wi_up"])
            return self.linear(h, w["wo_ffn"])
        m = w["moe"]
        probs = torch.softmax(x @ m["router"], dim=-1)        # all experts
        top_p, top_i = probs.topk(self.moe["top_k"], dim=-1)
        if self.moe.get("renormalize", True):
            top_p = top_p / top_p.sum(-1, keepdim=True)
        first = self.moe.get("first_expert", 0)
        y = torch.zeros_like(x)
        for e in range(m["wg"].shape[0]):                     # held ones
            rows, slot = (top_i == first + e).nonzero(as_tuple=True)
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
            xs = [P["embed"][s.long()].to(f32) for s in seqs]
            for blk in P["blocks"]:
                w = self._fp32(blk)
                if "wq" in w:
                    xs = [x + self.attention(self.rms(x, w["attn_norm"]), w)
                          for x in xs]
                else:
                    ys = self.mamba([self.rms(x, w["ssm_norm"]) for x in xs],
                                    w["ssm"])
                    xs = [x + y for x, y in zip(xs, ys)]
                xs = [x + self.ffn(self.rms(x, w["ffn_norm"]), w)
                      for x in xs]
                del w
            head = P["lm_head"][:, :self.V].to(f32)
            fn = P["final_norm"].to(f32)
            return [self.linear(self.rms(x[-n:], fn), head)
                    for x, n in zip(xs, n_last)]


def attn_layers(p: Dict[str, Any]) -> int:
    """Layers that run the flash kernel in a prefill and the paged kernel
    in a decode step: the attention layers."""
    return sum(_attends(p, i) for i in range(p["num_layers"]))


def _token_weights(p: Dict[str, Any]) -> Tuple[float, int]:
    """(projection weights one token passes through over all layers, the
    Mamba-1 layers); the experts at this card's share of the top k."""
    d = counts.dims(p)
    D, H, Hkv, dh = d["D"], d["H"], d["Hkv"], d["dh"]
    di, ds, K, R = _mamba_dims(p)
    attn = D * H * dh + 2 * D * Hkv * dh + H * dh * D
    mamba = D * 2 * di + di * K + di * (R + 2 * ds) + R * di + di * D
    m = p["moe"]
    moe = D * _routed(m) + (m["top_k"] * m["num_experts"] / _routed(m)
                            * 3 * D * m["d_ff_expert"])
    n = 0.0
    n_mamba = 0
    for i in range(d["L"]):
        if _attends(p, i):
            n += attn
        else:
            n += mamba
            n_mamba += 1
        n += moe if _has_experts(p, i) else 3 * D * p["d_ff"]
    return n, n_mamba


def _scan_flops(p, tokens: int, n_mamba: int) -> float:
    di, ds, _, _ = _mamba_dims(p)
    return float(SCAN_FLOPS * di * ds * tokens * n_mamba)


def prefill_flops(p, S: int) -> float:
    """Model FLOPs of one prompt's prefill: the layers over S tokens, the
    recurrence, causal attention, the head at the last position."""
    w, n_mamba = _token_weights(p)
    d = counts.dims(p)
    return (2.0 * S * w + _scan_flops(p, S, n_mamba)
            + attn_layers(p) * counts.attn_prefill_flops(p, S)
            + 2.0 * d["D"] * d["V"])


def decode_flops(p, active: int, ctx_sum: int) -> float:
    """Model FLOPs of one decode step over ``active`` requests whose
    attended positions sum to ``ctx_sum``."""
    w, n_mamba = _token_weights(p)
    d = counts.dims(p)
    return (2.0 * active * (w + d["D"] * d["V"])
            + _scan_flops(p, active, n_mamba)
            + attn_layers(p) * counts.attn_decode_flops(p, ctx_sum))
