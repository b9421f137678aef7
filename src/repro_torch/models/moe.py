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
``torch.bmm`` and a gather. Without a mesh ``_local_moe`` runs on every
token. Under a device mesh (``parallel.sharding.use_mesh``) ``moe_ffn``
takes the reference's two mesh branches, on the same conditions, each
rank running ``_local_moe`` on its own shards (``shard_map``):

- ``shard_map`` (tokens sharded over the data axes): each rank routes its
  data shard's tokens over all experts, with the capacity of that shard's
  token count, and runs its E/ep experts (``e_off`` from its coordinate
  on the model axis); its partial [T, D] is summed over the model axis
  and the metrics are averaged (``dropped`` summed) over the data axes;
- ``expert_tp`` (tokens replicated, expert d_ff over the data axes as
  well): each rank runs its experts' d_ff slice on every token, and the
  partials are summed over every axis.

The reference ``psum``s inside its ``shard_map``; here a rank's partials
leave as ``Partial`` DTensors and are summed (in fp32 under
``combine_fp32``) before the cast, as there. Capacity per data shard
means a sharded run differs from an unsharded one by design: its
counterpart is the reference's ``shard_map`` run on the same mesh.

The padded path makes no host synchronisation: C is computed in Python
from the token count, and the metrics (``moe_aux_loss``, ``moe_z_loss``,
``moe_dropped``) stay tensors. No atomics either, so a run is
bit-reproducible on the card. The reference scatter-adds the gated outputs
into their tokens' rows; its PyTorch twin, ``index_add_``, adds with
atomics in no fixed order on CUDA, and was the one op of granite's bf16
paths whose relaunch differed. The combine here gathers each token's k
gated outputs through a token -> slot table (a dropped pair points at a
zero row) and sums them over the slot axis, in the reference's slot
order (ascending expert). The slot -> token table is written with
``index_put_``; its duplicate indices all land in the drop column C, cut
off before use, and all write the same sentinel.

One card of an expert-parallel deployment with no mesh: a ``MoEConfig``
with ``router_experts`` routes every token over that many experts and
runs the ``num_experts`` it holds from ``first_expert`` on; what the
others would add is left out (the program stands in for no other card).
``renormalize=False`` keeps the top-k gates as the softmax over all the
router's experts gave them (Jamba's), where the reference's sum to 1.

A long prompt on the card takes a second way through ``_local_moe``,
the grouped dispatch (``grouped=True``, chosen by ``grouped_pays``): the
same routing, capacity and drops, but each held expert runs over its own
kept rows only, not over C padded slots. A running count over the kept
pairs of the held experts in (expert, token) order gives each pair its
row and each expert its last row; those are read to the host once,
through a pinned buffer: the call's one host synchronisation. The rows
are gathered once into [N, D] (N kept pairs of the held experts), each
expert with rows runs the same SwiGLU with ``torch.mm`` over its
contiguous slice, written into one preallocated output, and the combine
gathers each token's k rows through a token -> row table (a dropped or
other-card pair points at a zero row), gates them and sums them in the
padded path's order. ``grouped_calls`` counts the grouped calls.

Under a ``torch.profiler`` session ``_local_moe``'s four phases are spans
on the profiler's clock (``serving.tracing.span``): ``repro_torch.moe.
route`` (the router), ``.dispatch`` (slots, the slot table and the
gather; the grouped path's rows and host read), ``.experts`` (the
three batched products, or the grouped path's products a held expert)
and ``.combine`` (the gates and the gather-sum).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.hardware import GPU_H100
from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig
from repro_torch.parallel.sharding import (constrain, current_mesh,
                                           current_rules, mesh_coordinate,
                                           mesh_dims, mesh_shape,
                                           placements_for,
                                           shard_map_placements)
from repro_torch.serving.tracing import span

f32 = torch.float32

# the calls that took the grouped dispatch (``grouped_pays``)
grouped_calls = 0


def expert_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(cfg.capacity_factor * num_tokens * cfg.top_k
                  / cfg.routed)
    return int(min(num_tokens, max(c, cfg.min_capacity)))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(x, router_w, cfg: MoEConfig):
    """Returns (gates [T,E] dense fp32, mask [T,E] int32, aux loss, z
    loss): the reference's softmax router with its top-k renormalised
    (unless ``cfg.renormalize`` is False)."""
    logits = x.to(f32) @ router_w.to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = top_k(probs, cfg.top_k)                    # [T,k]
    if cfg.renormalize:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    mask = torch.zeros(probs.shape, dtype=torch.int32, device=x.device)
    mask.scatter_(1, top_ids, 1)
    gates = torch.zeros_like(probs).scatter_(1, top_ids, top_p)
    frac_tokens = mask.to(f32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = cfg.routed * (frac_tokens * frac_probs).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return gates, mask, aux, z


def grouped_pays(x, cfg: MoEConfig) -> bool:
    """Whether ``moe_ffn``'s unsharded call on tokens ``x`` [T, D] takes the
    grouped dispatch: on a CUDA tensor, with autograd off (the engine's
    ``inference_mode``), outside a CUDA graph capture (the grouped path
    reads its counts to the host, which no capture can hold), and only
    where the padded path's expert product is compute-bound: C*D*F /
    (C*D + D*F + C*F), its FLOPs over the elements it reads and writes, at
    least the H100's bf16 FLOP/s over its HBM bytes/s (~295). Below that
    line a padded product is bound by reading the expert's weights, which
    the grouped path reads as well; above it the padded slots cost
    compute, and their gathers and fp32 SwiGLU chain cost bytes, that the
    grouped path skips at the price of three launches a held expert and
    a host read. Timed alone on the card, the grouped way is the faster
    from 256 tokens on at Jamba's widths (by 3-12% there; the line: 326)
    and from between 2,048 and 4,096 at granite's (the line: 2,186),
    PERF.md."""
    if not x.is_cuda or torch.is_grad_enabled():
        return False
    if torch.cuda.is_current_stream_capturing():
        return False
    D = x.shape[-1]
    C, F_ = expert_capacity(x.shape[0], cfg), cfg.d_ff_expert
    intensity = C * D * F_ / (C * D + D * F_ + C * F_)
    return intensity >= GPU_H100.flops_bf16 / GPU_H100.hbm_bw


def _local_moe(x, router_w, wg, wu, wd, *, cfg: MoEConfig,
               combine_fp32: bool = True, e_off: int = 0,
               grouped: bool = False):
    """x: [T, D] tokens; wg/wu: [E_local, D, F], wd: [E_local, F, D], the
    experts [e_off, e_off + E_local) (all of them without a mesh). Returns
    (y [T,D] over those experts, in fp32 under ``combine_fp32``, else in
    x's dtype; metrics). ``grouped``: each held expert runs over its kept
    rows only (the module's docstring), with one host synchronisation."""
    T, D = x.shape
    E = cfg.routed
    E_local = wg.shape[0]
    C = expert_capacity(T, cfg)
    dev = x.device

    with span("repro_torch.moe.route"):
        gates, mask, aux_loss, z_loss = _route(x, router_w, cfg)

    if grouped:
        y, dropped = _grouped_moe(x, gates, mask, C, wg, wu, wd, k=cfg.top_k,
                                  combine_fp32=combine_fp32, e_off=e_off)
        return y, {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
                   "moe_dropped": dropped}

    with span("repro_torch.moe.dispatch"):
        pos, keep, dropped = _slots(mask, C)

        # slot -> token table, sentinel T = padded zero row; every dropped
        # or unrouted pair writes T into the drop slot C, which is cut off
        tok_ids = torch.arange(T, device=dev)[:, None].expand(T, E)
        e_ids = torch.arange(E, device=dev)[None, :].expand(T, E)
        safe_pos = torch.where(keep, pos, C)
        slot_tok = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
        slot_tok.index_put_((e_ids.reshape(-1), safe_pos.reshape(-1)),
                            torch.where(keep, tok_ids, T).reshape(-1))
        # this rank's experts' slots [E_local*C]
        slot_tok = slot_tok[e_off:e_off + E_local, :C].reshape(-1)

        # gather expert inputs [E_local, C, D]
        x_pad = torch.cat([x, x.new_zeros((1, D))])
        xe = x_pad.index_select(0, slot_tok).reshape(E_local, C, D)

    with span("repro_torch.moe.experts"):
        # expert SwiGLU as three batched products
        h = torch.bmm(xe, wg)
        u = torch.bmm(xe, wu)
        h = F.silu(h.to(f32)).to(x.dtype) * u
        ye = torch.bmm(h, wd)                             # [E_local,C,D]

    with span("repro_torch.moe.combine"):
        # per-slot gate value: gates[token, expert]
        gates_pad = torch.cat([gates, gates.new_zeros((1, E))])
        slot_gate = gates_pad[slot_tok.reshape(E_local, C),
                              e_off + torch.arange(E_local,
                                                   device=dev)[:, None]]

        # combine in fp32 without atomics: token t's k routed experts in
        # ascending order (a stable sort of its mask row puts them first),
        # each pair's slot (e - e_off)*C + pos, or the zero row E_local*C
        # where it was dropped or its expert is another rank's; the gated
        # outputs gathered [T, k, D] and summed over the slot axis
        k = cfg.top_k
        t_exp = torch.sort(mask, dim=1, descending=True,
                           stable=True)[1][:, :k]
        mine = keep.gather(1, t_exp) & (t_exp >= e_off) \
            & (t_exp < e_off + E_local)
        t_slot = torch.where(mine,
                             (t_exp - e_off) * C + pos.gather(1, t_exp),
                             E_local * C)
        yg = (ye.to(f32) * slot_gate[..., None]).reshape(E_local * C, D)
        yg = torch.cat([yg, yg.new_zeros((1, D))])
        y = yg[t_slot].sum(dim=1)
        if not combine_fp32:
            y = y.to(x.dtype)
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_dropped": dropped}
    return y, aux


def _slots(mask, C: int):
    """(pos [T,E]: token t's position in expert e's buffer, a cumsum over
    tokens; keep [T,E]: the routed pairs inside the capacity C; the
    dropped count, fp32)."""
    pos = torch.cumsum(mask, dim=0) - 1
    keep = (mask == 1) & (pos < C)
    return pos, keep, (mask.sum() - keep.sum()).to(f32)


def _grouped_moe(x, gates, mask, C: int, wg, wu, wd, *, k: int,
                 combine_fp32: bool, e_off: int):
    """``_local_moe``'s grouped dispatch after routing: (y [T, D] as the
    padded path gives it, the dropped count), each held expert run over
    its kept rows only. Row r >= 1 of the grouped buffer is the r-th kept
    pair of the held experts in (expert, token) order: a running count
    over the pairs in that order, which gives each pair its row and each
    expert its last row. Row 0 is the zero row of every other pair. The
    host, at 20-30 us a launch, is the slower side of a jamba prompt
    once its experts run over their rows only, so the path is written in
    few launches: a running count where a device radix sort takes eight,
    one split a buffer and one unbind a weight, the SwiGLU's elementwise
    chain once over all rows."""
    global grouped_calls
    grouped_calls += 1
    T, D = x.shape
    E_local, _, F_ = wg.shape
    E = mask.shape[1]

    with span("repro_torch.moe.dispatch"):
        _, keep, dropped = _slots(mask, C)
        held = keep[:, e_off:e_off + E_local].t().reshape(-1)
        rank = torch.cumsum(held, dim=0)                     # [E_local*T]
        row = torch.where(held, rank, 0).view(E_local, T)
        ends = rank.view(E_local, T)[:, -1]
        if x.is_cuda:       # the call's one host synchronisation
            host = torch.empty((E_local,), dtype=ends.dtype, pin_memory=True)
            host.copy_(ends, non_blocking=True)
            torch.cuda.current_stream(x.device).synchronize()
            ends = host.tolist()
        else:
            ends = ends.tolist()
        n_rows = [b - a for a, b in zip([0] + ends[:-1], ends)]
        N = ends[-1]
        # row -> token; every other pair writes its token into row 0
        tok = torch.empty((N + 1,), dtype=torch.long, device=x.device)
        tok[row] = torch.arange(T, device=x.device)
        xg = x.index_select(0, tok[1:])                         # [N, D]

    with span("repro_torch.moe.experts"):
        # the padded path's SwiGLU, each held expert over its own rows
        h = x.new_empty((N, F_))
        u = x.new_empty((N, F_))
        ye = x.new_empty((N + 1, D))
        ye[0].zero_()
        parts = zip(n_rows, xg.split(n_rows), h.split(n_rows),
                    u.split(n_rows), wg.unbind(0), wu.unbind(0))
        for n, xs, hs, us, g_e, u_e in parts:
            if n:
                torch.mm(xs, g_e, out=hs)
                torch.mm(xs, u_e, out=us)
        h = F.silu(h.to(f32)).to(x.dtype) * u
        for n, hs, ys, d_e in zip(n_rows, h.split(n_rows),
                                  ye[1:].split(n_rows), wd.unbind(0)):
            if n:
                torch.mm(hs, d_e, out=ys)

    with span("repro_torch.moe.combine"):
        # combine in fp32 without atomics, as the padded path: token t's
        # k routed experts in ascending order, each pair's row (the zero
        # row where it was dropped or its expert is another card's); the
        # rows gathered [T, k, D], gated and summed over the k
        t_exp = torch.sort(mask, dim=1, descending=True,
                           stable=True)[1][:, :k]
        rows = F.pad(row.t(), (e_off, E - e_off - E_local))     # [T, E]
        t_row = rows.gather(1, t_exp)
        y = (ye.to(f32)[t_row] * gates.gather(1, t_exp)[..., None]).sum(1)
        if not combine_fp32:
            y = y.to(x.dtype)
    return y, dropped


def moe_ffn(x, params, cfg: MoEConfig, *, combine_fp32: bool = True,
            expert_tp: bool = False) -> Tuple[torch.Tensor, Dict]:
    """x: [B, S, D]; params: router [D,E] (fp32), wg/wu [E,D,F], wd
    [E,F,D] (+ shared_wg/shared_wu [D,F'], shared_wd [F',D]). Returns (y
    [B,S,D], metrics).

    Every token of the call (of a data shard, under a mesh) shares the
    capacity, so a decode step's inactive slots route and take slots too,
    as in the reference. ``expert_tp`` (expert d_ff sharded over the data
    axes) acts only under a device mesh, as in the reference."""
    B, S, D = x.shape
    mesh = current_mesh() if isinstance(x, DTensor) else None
    rules = current_rules()
    shape = mesh_shape(mesh) if mesh is not None else {}
    ep_size = math.prod(shape[a] for a in rules.ep) if mesh else 1
    dp_size = math.prod(shape[a] for a in rules.dp) if mesh else 1
    dff = params["wg"].shape[-1]
    E = cfg.num_experts
    use_expert_tp = (expert_tp and mesh is not None and ep_size > 1
                     and E % ep_size == 0 and dp_size > 1
                     and dff % dp_size == 0)
    use_shard_map = (mesh is not None and ep_size > 1 and E % ep_size == 0
                     and (B * S) % dp_size == 0 and B % dp_size == 0)
    xf = x.reshape(B * S, D)
    w = (params["router"], params["wg"], params["wu"], params["wd"])
    if use_expert_tp or use_shard_map:
        y, aux = _moe_sharded(xf, w, cfg, combine_fp32, use_expert_tp)
    elif mesh is not None:      # every rank routes every token over all
        rep = (Replicate(),) * mesh.ndim    # experts, as GSPMD would
        y, *aux = shard_map_placements(
            lambda *a: _flat(_local_moe(*a, cfg=cfg,
                                        combine_fp32=combine_fp32)),
            (xf, *w), (rep,) * 5, (rep,) * 4)
        aux = dict(zip(_METRICS, aux))
    else:
        grouped = grouped_pays(xf, cfg)
        y, aux = _local_moe(xf, *w, cfg=cfg, combine_fp32=combine_fp32,
                            e_off=cfg.first_expert, grouped=grouped)
    y = y.to(x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + L.swiglu(x, params["shared_wg"], params["shared_wu"],
                         params["shared_wd"])
    return y, aux


_METRICS = ("moe_aux_loss", "moe_z_loss", "moe_dropped")


def _flat(out):
    y, aux = out
    return (y, *(aux[k] for k in _METRICS))


def _moe_sharded(xf, w, cfg: MoEConfig, combine_fp32: bool,
                 expert_tp: bool):
    """The reference's two ``shard_map`` branches of ``moe_ffn`` on the
    ambient mesh: (y [T, D] summed over the ranks' partials, in fp32 under
    ``combine_fp32``, metrics replicated)."""
    mesh = current_mesh()
    if expert_tp:       # tokens replicated; experts (ep) x d_ff (dp)
        x_pl = placements_for(xf.shape, None, None)
        wgu_pl = placements_for(w[1].shape, "ep", None, "dp")
        wd_pl = placements_for(w[3].shape, "ep", "dp", None)
    else:               # tokens over dp; experts (ep)
        x_pl = placements_for(xf.shape, "dp", None)
        wgu_pl = wd_pl = placements_for(w[1].shape, "ep", None, None)
    r_pl = placements_for(w[0].shape, None, None)
    ep_dims = mesh_dims(mesh, wgu_pl, 0)
    # a rank's y is a summand over every dim that splits the experts or
    # their d_ff; the metrics, the same on the ranks of a data shard, are
    # spread as equal summands over the others and averaged over the data
    # shards (``moe_dropped`` summed)
    y_pl = tuple(Shard(0) if pl == Shard(0) else Partial()
                 for pl in x_pl)
    data_dims = mesh_dims(mesh, x_pl, 0)
    n_data = math.prod(mesh.size(i) for i in data_dims)
    n_rest = mesh.size() // n_data

    share = {"moe_aux_loss": n_data * n_rest, "moe_z_loss": n_data * n_rest,
             "moe_dropped": n_rest}

    def local(x, router, wg, wu, wd):
        e_off = mesh_coordinate(mesh, ep_dims) * wg.shape[0]
        y, aux = _local_moe(x, router, wg, wu, wd, cfg=cfg,
                            combine_fp32=combine_fp32, e_off=e_off)
        return (y, *(aux[k] / share[k] for k in _METRICS))

    m_pl = (Partial(),) * mesh.ndim
    y, *aux = shard_map_placements(
        local, (xf, *w), (x_pl, r_pl, wgu_pl, wgu_pl, wd_pl),
        (y_pl,) + (m_pl,) * len(_METRICS))
    y = constrain(y, *(("dp", None) if not expert_tp else (None, None)))
    rep = (Replicate(),) * mesh.ndim
    return y, {k: v.redistribute(mesh, rep) for k, v in zip(_METRICS, aux)}
