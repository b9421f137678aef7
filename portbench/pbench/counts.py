"""Operations and bytes from shapes, and the table of peaks.

Every count follows the operation, not the kernel that implements it, so
that a later kernel is measured against the same work. Model FLOPs, which
each architecture's module counts (``archs/<arch>.py``: ``prefill_flops``,
``decode_flops``), count the multiply-adds the model needs (2 per weight
per token through the layers' projections, the top-k experts only for a
mixture, the head at the positions whose logits are taken, and causal
attention from the counts here), never padded work such as a capacity
buffer's empty slots or a decode batch's idle slots. What all
architectures share is here: one layer's attention by its heads (H, Hkv,
dh), the peaks and ``bound_s``. Attention bytes count each input byte
read once and each output byte written once (bf16 operands): Q, K, V and
O of a prompt; Q, the attended K and V rows and O of a decode step. The
block tables and lengths a decode call also reads are left out (under
0.1% of its bytes at these shapes), which can only lower a bound.
"""
from __future__ import annotations

from typing import Any, Dict

# NVIDIA H100 SXM data sheet, dense rates at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16 = 2


def dims(p: Dict[str, Any]) -> Dict[str, int]:
    D, H = p["d_model"], p["num_heads"]
    return {"L": p["num_layers"], "D": D, "H": H, "Hkv": p["num_kv_heads"],
            "dh": p.get("head_dim") or D // H, "V": p["vocab_size"]}


def attn_prefill_flops(p, S: int) -> float:
    """Causal attention of one S-token prompt in one layer: QK^T and PV
    over the S(S+1)/2 query-key pairs, 2 dh each, for every query head."""
    d = dims(p)
    return 2.0 * d["H"] * d["dh"] * S * (S + 1)


def attn_prefill_bytes(p, S: int) -> float:
    d = dims(p)
    return BF16 * S * d["dh"] * (2 * d["H"] + 2 * d["Hkv"])


def attn_decode_flops(p, ctx_sum: int) -> float:
    """One decode step's attention in one layer over ``ctx_sum`` attended
    positions summed over the batch's rows."""
    d = dims(p)
    return 4.0 * d["H"] * d["dh"] * ctx_sum


def attn_decode_bytes(p, rows: int, ctx_sum: int) -> float:
    d = dims(p)
    return BF16 * d["dh"] * (2 * rows * d["H"] + 2 * ctx_sum * d["Hkv"])


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
