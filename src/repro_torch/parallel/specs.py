"""PartitionSpecs for params, optimizer state, caches and batches: the
port's counterpart of ``repro.parallel.specs``.

Rules: TP over "model" (heads / ffn-hidden / vocab), EP over "model"
(experts), DP/FSDP over ("pod","data"). Explicit input shardings must
divide evenly, so:
  - q-head counts are padded to the model-axis multiple at the *parameter*
    level (ModelConfig.pad_heads_to; masked in the o-projection);
  - vocab is padded via ModelConfig.vocab_pad (logits masked);
  - KV caches shard the *sequence* dim over the model axis when kv-head
    counts don't divide it (context-parallel decode attention); batch=1
    long-context decode shards the sequence over every axis;
  - anything else non-divisible falls back to replication (sanitize_spec).

Two layouts differ from the reference's. The port keeps
``params["blocks"]`` as a list of per-layer dicts where the reference
stacks ``[L, ...]``: a block leaf's spec here is the reference's stacked
spec without its leading None (``param_pspec``). Its
Adafactor state *is* stacked per leaf group (``train/optimizer.py``), so
``opt_state_shardings`` gives it the stacked spec, as the reference does.
KV caches are stacked in both.

Each ``*_shardings`` function returns a tree shaped like its input, of
``NamedSharding`` (a spec on an ``AbstractMesh`` or a ``DeviceMesh``);
``distribute_params`` turns real parameters into DTensors by it.
"""
from __future__ import annotations

import math

from torch.distributed.tensor import distribute_tensor

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (P, NamedSharding, ShardingRules,
                                           make_rules, mesh_shape,
                                           sanitize_spec)
from repro_torch.tree import flatten_with_paths, unflatten_like


def _map_with_path(fn, tree):
    return unflatten_like(tree, [fn(path, leaf) for path, leaf in
                                 flatten_with_paths(tree)])


def param_pspec(key: str, shape, cfg: ModelConfig, r: ShardingRules,
                block: bool) -> P:
    """PartitionSpec for one parameter leaf; ``block``: a layer's leaf,
    whose spec is the reference's stacked one without its leading None."""
    name = key.split("/")[-1]
    tp, ep, fsdp, vocab = r.tp or None, r.ep or None, r.fsdp or None, r.vocab or None

    table = {
        # embedding / head
        "embed": P(vocab, fsdp),
        "lm_head": P(fsdp, vocab),
        # attention
        "wq": P(fsdp, tp, None),
        "wk": P(fsdp, tp, None),
        "wv": P(fsdp, tp, None),
        "wo": P(tp, None, fsdp),
        "bq": P(tp, None),
        "bk": P(tp, None),
        "bv": P(tp, None),
        # dense ffn
        "wi_gate": P(fsdp, tp),
        "wi_up": P(fsdp, tp),
        "wo_ffn": P(tp, fsdp),
        # moe
        "router": P(None, None),
        "wg": P(ep, fsdp, None),
        "wu": P(ep, fsdp, None),
        "wd": P(ep, None, fsdp),
        "shared_wg": P(fsdp, tp),
        "shared_wu": P(fsdp, tp),
        "shared_wd": P(tp, fsdp),
        # rwkv time-mix / channel-mix
        "wr": P(fsdp, tp),
        "w_lora_a": P(fsdp, None),
        "w_lora_b": P(None, None),
        "cm_wk": P(fsdp, tp),
        "cm_wv": P(tp, fsdp),
        "cm_wr": P(fsdp, tp),
        # ssm
        "in_proj": P(fsdp, tp),
        "out_proj": P(tp, fsdp),
        "x_proj": P(tp, None),
        "conv_w": P(None, tp),
        "A_log": P(tp, None),
        # vision projector
        "w1": P(fsdp, tp),
        "w2": P(fsdp, tp),
    }
    if name in table:
        spec = table[name]
        if len(spec) == len(shape):
            return spec
    # rwkv square projections share names (wk/wv/wg/wo) with attention but
    # are [D, D] / [D, F] a layer; shard input dim fsdp, output dim tp
    if block and len(shape) == 2:
        if name in ("wk", "wv", "wg"):
            return P(fsdp, tp)
        if name == "wo":
            return P(tp, fsdp)
    # default: replicate (norms, scalars, mu, u, biases, dt, D_skip ...)
    return P(*([None] * len(shape)))


def params_shardings(cfg: ModelConfig, params, mesh, fsdp: bool = False,
                     expert_tp: bool = False):
    """Tree of NamedShardings matching ``params`` (real, meta or any tree
    of shaped leaves in the port's layout).

    expert_tp: serving layout for giant MoE -- expert weights sharded
    (experts -> model axis, d_ff -> data axes) so they are fully resident
    with no per-step gathers (pairs with ModelConfig.moe_expert_tp)."""
    r = make_rules(mesh, fsdp=fsdp)
    dp = make_rules(mesh, fsdp=True).fsdp     # the data axes

    def assign(key, leaf):
        name = key.split("/")[-1]
        block = key.startswith("blocks/")
        if (expert_tp and block and name in ("wg", "wu", "wd")
                and len(leaf.shape) == 3):
            spec = (P(r.ep, None, dp) if name in ("wg", "wu")
                    else P(r.ep, dp, None))
        else:
            spec = param_pspec(key, leaf.shape, cfg, r, block)
        return NamedSharding(mesh, sanitize_spec(spec, leaf.shape, mesh))

    return _map_with_path(assign, params)


def opt_state_shardings(param_shardings, opt_state, mesh):
    """Optimizer state shardings derived from param specs.

    adamw m/v mirror params; adafactor vr/vc drop the last / second-to-last
    dim of the param spec -- the stacked spec for a block leaf group (its
    per-layer spec under a leading None); scalars replicate."""
    flat_ps = {k: s for k, s in flatten_with_paths(param_shardings)}
    for key, s in list(flat_ps.items()):
        parts = key.split("/")
        if parts[0] == "blocks" and parts[1] == "0":
            flat_ps.setdefault("/".join(["blocks"] + parts[2:]),
                               NamedSharding(mesh, P(None, *s.spec)))

    def assign(key, leaf):
        parts = key.split("/")
        if parts[-1] in ("count",):
            return NamedSharding(mesh, P())
        # strip the optimizer-state prefix/suffix to find the param key
        if parts[0] in ("m", "v"):
            pkey = "/".join(parts[1:])
            if pkey in flat_ps:
                return flat_ps[pkey]
        if parts[0] == "s":
            pkey = "/".join(parts[1:-1])
            if pkey in flat_ps:
                spec = flat_ps[pkey].spec
                if parts[-1] == "vr":
                    return NamedSharding(
                        mesh, sanitize_spec(P(*spec[:-1]), leaf.shape, mesh))
                if parts[-1] == "vc":
                    return NamedSharding(mesh, sanitize_spec(
                        P(*(tuple(spec[:-2]) + (spec[-1],))), leaf.shape,
                        mesh))
                if parts[-1] == "v":
                    return flat_ps[pkey]
        return NamedSharding(mesh, P(*([None] * len(leaf.shape))))

    return _map_with_path(assign, opt_state)


def batch_shardings(batch, mesh, batch_shardable: bool = True):
    r = make_rules(mesh)
    dp = r.dp or None

    def assign(_, leaf):
        if not batch_shardable or not dp:
            return NamedSharding(mesh, P(*([None] * len(leaf.shape))))
        return NamedSharding(mesh, sanitize_spec(
            P(dp, *([None] * (len(leaf.shape) - 1))), leaf.shape, mesh))

    return _map_with_path(assign, batch)


def cache_shardings(cfg: ModelConfig, cache, mesh, batch: int):
    """KV-cache shardings; falls back to sequence-parallel when batch=1."""
    r = make_rules(mesh)
    dp = r.dp or None
    tp = r.tp or None
    shape = mesh_shape(mesh)
    dp_size = math.prod(shape[a] for a in (r.dp or ())) if dp else 1
    batch_ok = dp is not None and batch % max(dp_size, 1) == 0
    tp_size = math.prod(shape[a] for a in (r.tp or ())) if tp else 1

    def assign(key, leaf):
        name = key.split("/")[-1]
        nd = len(leaf.shape)
        if name == "pos":
            return NamedSharding(mesh, P())
        bdim = dp if batch_ok else None
        if name in ("k", "v"):
            # [L, B, C, Hkv, dh]. KV heads rarely divide the model axis;
            # shard the *sequence* dim over model instead (context-parallel
            # decode attention).
            if cfg.padded_kv_heads % tp_size == 0 and tp_size > 1:
                kv_heads_dim, seq_dim = tp, (None if batch_ok else dp)
            else:
                kv_heads_dim, seq_dim = None, (tp if batch_ok
                                               else (dp or ()) + (tp or ()))
            return NamedSharding(
                mesh, sanitize_spec(P(None, bdim, seq_dim, kv_heads_dim,
                                      None), leaf.shape, mesh))
        if name == "s":         # rwkv state [L, B, H, N, N]
            # batch shardable: heads over tp; batch=1: heads over dp
            hdim = tp if batch_ok else dp
            return NamedSharding(mesh, sanitize_spec(
                P(None, bdim, hdim, None, None), leaf.shape, mesh))
        if name in ("k_scale", "v_scale"):   # [L, B, C, Hkv]
            if cfg.padded_kv_heads % tp_size == 0 and tp_size > 1:
                return NamedSharding(mesh, sanitize_spec(
                    P(None, bdim, None, tp), leaf.shape, mesh))
            seq_dim = tp if batch_ok else (dp or ()) + (tp or ())
            return NamedSharding(mesh, sanitize_spec(
                P(None, bdim, seq_dim, None), leaf.shape, mesh))
        if name in ("tm_x", "cm_x"):   # [L, B, D]
            return NamedSharding(mesh, sanitize_spec(
                P(None, bdim, None), leaf.shape, mesh))
        if name == "ssm_h":     # [L, B, di, ds]
            return NamedSharding(mesh, sanitize_spec(
                P(None, bdim, tp, None), leaf.shape, mesh))
        if name == "conv":      # [L, B, K-1, di]
            return NamedSharding(mesh, P(None, bdim, None, tp))
        return NamedSharding(mesh, P(*([None] * nd)))

    return _map_with_path(assign, cache)


def distribute_params(params, cfg: ModelConfig, mesh, *, fsdp: bool = False,
                      expert_tp: bool = False):
    """The port's parameters (``init_params``, or the reference's carried
    across by ``convert.from_reference``) as DTensors on ``mesh``, laid out
    by ``params_shardings``."""
    shardings = params_shardings(cfg, params, mesh, fsdp=fsdp,
                                 expert_tp=expert_tp)
    return unflatten_like(params, [
        distribute_tensor(t, s.mesh, s.placements) for (_, t), (_, s) in
        zip(flatten_with_paths(params), flatten_with_paths(shardings))])
