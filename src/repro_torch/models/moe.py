"""The MoE FFN of ``repro.models.moe`` in PyTorch, on one device.

Dispatch is capacity-based and sort-free, as in the reference: routing
gives each token its top-k experts; a cumsum over the flattened tokens
gives each (token, expert) pair its slot in that expert's buffer of C
slots (``expert_capacity``); pairs past C are dropped. A small ``[E, C]``
slot -> token table (sentinel T: a zero row) moves the activations with
one gather, the experts run as three batched products, and each token's
gated outputs are summed back in fp32.

The reference computes all of this outside any Pallas kernel (XLA's
gathers, einsums and scatter), so the port does too: ``index_select``,
``torch.bmm`` and a gather. Its ``shard_map`` and ``expert_tp``
branches act only under a device mesh, which comes with the sharding
slice; without one the reference runs ``_local_moe`` on every token, as
here.

No host synchronisation: C is computed in Python from the token count,
and the metrics (``moe_aux_loss``, ``moe_z_loss``, ``moe_dropped``) stay
tensors. No atomics either, so a run is bit-reproducible on the card. The
reference scatter-adds the gated outputs into their tokens' rows; its
PyTorch twin, ``index_add_``, adds with atomics in no fixed order on
CUDA, and was the one op of granite's bf16 paths whose relaunch differed.
The combine here gathers each token's k gated outputs through a token ->
slot table (a dropped pair points at a zero row) and sums them over the
slot axis, in the reference's slot order (ascending expert). The slot ->
token table is written with ``index_put_``; its duplicate indices all land
in the drop column C, cut off before use, and all write the same
sentinel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig

f32 = torch.float32


def expert_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(cfg.capacity_factor * num_tokens * cfg.top_k
                  / cfg.num_experts)
    return int(min(num_tokens, max(c, cfg.min_capacity)))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(x, router_w, cfg: MoEConfig):
    """Returns (gates [T,E] dense fp32, mask [T,E] int32, aux loss, z
    loss): the reference's softmax router with its top-k renormalised."""
    logits = x.to(f32) @ router_w.to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = top_k(probs, cfg.top_k)                    # [T,k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)             # renorm
    mask = torch.zeros(probs.shape, dtype=torch.int32, device=x.device)
    mask.scatter_(1, top_ids, 1)
    gates = torch.zeros_like(probs).scatter_(1, top_ids, top_p)
    frac_tokens = mask.to(f32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = cfg.num_experts * (frac_tokens * frac_probs).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return gates, mask, aux, z


def _local_moe(x, router_w, wg, wu, wd, *, cfg: MoEConfig,
               combine_fp32: bool = True):
    """x: [T, D] tokens; wg/wu: [E, D, F], wd: [E, F, D]. Returns (y [T,D]
    in x's dtype, metrics)."""
    T, D = x.shape
    E = cfg.num_experts
    C = expert_capacity(T, cfg)
    dev = x.device

    gates, mask, aux_loss, z_loss = _route(x, router_w, cfg)

    # position of token t in expert e's buffer (cumsum over tokens)
    pos = torch.cumsum(mask, dim=0) - 1                         # [T,E]
    keep = (mask == 1) & (pos < C)
    dropped = (mask.sum() - keep.sum()).to(f32)

    # slot -> token table, sentinel T = padded zero row; every dropped or
    # unrouted pair writes T into the drop slot C, which is cut off
    tok_ids = torch.arange(T, device=dev)[:, None].expand(T, E)
    e_ids = torch.arange(E, device=dev)[None, :].expand(T, E)
    safe_pos = torch.where(keep, pos, C)
    slot_tok = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
    slot_tok.index_put_((e_ids.reshape(-1), safe_pos.reshape(-1)),
                        torch.where(keep, tok_ids, T).reshape(-1))
    slot_tok = slot_tok[:, :C].reshape(-1)                      # [E*C]

    # gather expert inputs [E, C, D]
    x_pad = torch.cat([x, x.new_zeros((1, D))])
    xe = x_pad.index_select(0, slot_tok).reshape(E, C, D)

    # expert SwiGLU as three batched products
    h = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    h = F.silu(h.to(f32)).to(x.dtype) * u
    ye = torch.bmm(h, wd)                                       # [E,C,D]

    # per-slot gate value: gates[token, expert]
    gates_pad = torch.cat([gates, gates.new_zeros((1, E))])
    slot_gate = gates_pad[slot_tok.reshape(E, C),
                          torch.arange(E, device=dev)[:, None]]  # [E,C]

    # combine in fp32 without atomics: token t's k routed experts in
    # ascending order (a stable sort of its mask row puts them first), each
    # pair's slot e*C + pos, or the zero row E*C where it was dropped; the
    # gated outputs gathered [T, k, D] and summed over the slot axis
    k = cfg.top_k
    t_exp = torch.sort(mask, dim=1, descending=True, stable=True)[1][:, :k]
    t_slot = torch.where(keep.gather(1, t_exp),
                         t_exp * C + pos.gather(1, t_exp), E * C)
    yg = (ye.to(f32) * slot_gate[..., None]).reshape(E * C, D)
    yg = torch.cat([yg, yg.new_zeros((1, D))])
    y = yg[t_slot].sum(dim=1)
    if not combine_fp32:
        y = y.to(x.dtype)
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_dropped": dropped}
    return y.to(x.dtype), aux


def moe_ffn(x, params, cfg: MoEConfig, *, combine_fp32: bool = True,
            expert_tp: bool = False) -> Tuple[torch.Tensor, Dict]:
    """x: [B, S, D]; params: router [D,E] (fp32), wg/wu [E,D,F], wd
    [E,F,D] (+ shared_wg/shared_wu [D,F'], shared_wd [F',D]). Returns (y
    [B,S,D], metrics).

    Every token of the call shares the capacity (T = B*S), so a decode
    step's inactive slots route and take slots too, as in the reference.
    ``expert_tp`` (expert d_ff sharded over the data axes) acts only under
    a device mesh, as in the reference, and is accepted and ignored
    here."""
    B, S, D = x.shape
    y, aux = _local_moe(x.reshape(B * S, D), params["router"], params["wg"],
                        params["wu"], params["wd"], cfg=cfg,
                        combine_fp32=combine_fp32)
    y = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + L.swiglu(x, params["shared_wg"], params["shared_wu"],
                         params["shared_wd"])
    return y, aux
