"""The decoder of ``repro.models.transformer`` in PyTorch: the dense
attention family and the attention-free RWKV-6 family.

Parameters keep the reference's names and layouts (``wq`` [D,Hp,dh],
``wo`` [Hp,dh,D], ...), with ``params["blocks"]`` a list of per-layer
dicts: the layer loop is a Python loop where the reference scans a stacked
``[L, ...]`` axis (``convert.py`` turns one into the other).

Every function that attends takes ``impl``: ``"kernel"`` runs the
hand-written CUDA kernels of ``repro_torch.kernels`` (on a CPU tensor their
wrappers run the plain version), ``"plain"`` runs the plain PyTorch
versions on any device. The serving engine picks ``"kernel"`` on CUDA.

Two KV layouts, as in the reference:

- **dense**: ``{"k","v": [L, B, C, Hkvp, dh], "pos": [B]}``, one row of
  capacity C per slot (``init_cache``, ``decode_step``,
  ``prefill_chunked``);
- **paged**: a block pool ``{"k","v": [N, Bs, Hkvp, dh]}`` shared by all
  layers and requests, addressed through per-layer block tables
  ``[L, slots, nb]`` (int32). Block 0 is the trash block: padded table
  columns and inactive decode slots point at it, and no live position
  ever reads it.

Both layouts are updated in place where the reference's jit returns new
arrays (or donates them).

The RWKV-6 family (``cfg.block == "rwkv"``, ``models/rwkv6.py``) keeps no
KV: its dense "cache" is the recurrent state ``{"s": [L, B, H, N, N] fp32,
"tm_x", "cm_x": [L, B, D], "pos": [B]}``, O(1) per request, so it has no
capacity and no paged layout, and its prefill is never chunked. Every WKV
runs through the WKV kernel under ``impl="kernel"``.

The MoE family (``cfg.moe`` set, e.g. granite-moe-1b-a400m) is the attention
family with every FFN the reference's capacity-based MoE
(``models/moe.py``); attention, both KV layouts and the kernels are the
same. The serving paths drop the MoE metrics, as the reference's do.

kv-quant, the sliding window and the hybrid family come with later slices
(``unported`` names which).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                     decode_attention_paged)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import moe, rwkv6
from repro_torch.models.config import ModelConfig

f32 = torch.float32
IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot run on the port yet (the slice that brings it),
    or None for the families it covers: dense attention, MoE and
    RWKV-6."""
    if cfg.block not in ("attn", "rwkv"):
        return f"{cfg.block} blocks come with the hybrid slice"
    if cfg.frontend:
        return f"the {cfg.frontend} frontend comes with the hybrid slice"
    if cfg.block == "rwkv":         # its own channel mix; no KV to quantize
        return None
    if cfg.kv_quant:
        return "kv-quant comes with the kv-quant / sliding-window slice"
    if cfg.sliding_window:
        return "the sliding window comes with the kv-quant / sliding-window slice"
    return None


def _check_family(cfg: ModelConfig) -> None:
    why = unported(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why}")


def _check_attn(cfg: ModelConfig, what: str) -> None:
    """Chunked prefill and the paged layout are for the attention family,
    as in the reference: an RWKV prompt runs whole (its recurrence is
    already chunked inside the WKV), and its O(1) state has nothing to
    page."""
    _check_family(cfg)
    if cfg.block != "attn":
        raise ValueError(f"{cfg.name}: {what} is for the attention family "
                         f"only, not {cfg.block} blocks")


# ---------------------------------------------------------------------------
# Init


def _normal(gen, shape, std, device, dtype):
    """N(0, std^2) drawn in fp32 on ``device``, then cast (the reference's
    ``(normal(f32) * std).astype(dt)``)."""
    x = torch.randn(shape, generator=gen, dtype=f32, device=device)
    return (x * std).to(dtype)


def _init_moe(gen, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """The reference's MoE FFN init (``_init_ffn_layer``): an fp32 router
    of std 0.02, experts ``wg``/``wu`` [E,D,F] and ``wd`` [E,F,D] of std
    1/sqrt(D) (``wd`` also over sqrt(L)), and the shared experts' SwiGLU
    [D,F*n] / [F*n,D] where the config has any."""
    m, D, dt = cfg.moe, cfg.d_model, cfg.tdtype
    E, F = m.num_experts, m.d_ff_expert
    s = 1.0 / math.sqrt(D)
    p = {"router": _normal(gen, (D, E), 0.02, device, f32),
         "wg": _normal(gen, (E, D, F), s, device, dt),
         "wu": _normal(gen, (E, D, F), s, device, dt),
         "wd": _normal(gen, (E, F, D), s / math.sqrt(cfg.num_layers), device,
                       dt)}
    if m.num_shared_experts:
        Fs = F * m.num_shared_experts
        p["shared_wg"] = _normal(gen, (D, Fs), s, device, dt)
        p["shared_wu"] = _normal(gen, (D, Fs), s, device, dt)
        p["shared_wd"] = _normal(gen, (Fs, D), s, device, dt)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device) -> Dict[str, Any]:
    """Random parameters with the reference's distributions and scales
    (``transformer.py`` ``_init_attn_layer`` / ``_init_ffn_layer`` /
    ``init_params``; ``rwkv6.init_rwkv_block`` for an RWKV layer; an MoE
    layer's FFN under ``p["moe"]``), drawn
    from a ``torch.Generator`` on ``device``. The
    numbers differ from ``jax.random``'s; tests that need both packages on
    the same weights convert the JAX ones (``repro_torch.convert``)."""
    _check_family(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D, dh, V, F = cfg.d_model, cfg.dh, cfg.padded_vocab, cfg.d_ff
    Hp, Hkv = cfg.padded_heads, cfg.padded_kv_heads
    dt = cfg.tdtype
    s = 1.0 / math.sqrt(D)
    deep = s / math.sqrt(cfg.num_layers)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    blocks: List[Dict[str, torch.Tensor]] = []
    for _ in range(cfg.num_layers):
        if cfg.block == "rwkv":
            blocks.append(rwkv6.init_rwkv_block(gen, cfg, device=device))
            continue
        p = {
            "attn_norm": ones(D),
            "wq": _normal(gen, (D, Hp, dh), s, device, dt),
            "wk": _normal(gen, (D, Hkv, dh), s, device, dt),
            "wv": _normal(gen, (D, Hkv, dh), s, device, dt),
            "wo": _normal(gen, (Hp, dh, D), deep, device, dt),
            "ffn_norm": ones(D),
        }
        if cfg.moe is not None:
            p["moe"] = _init_moe(gen, cfg, device)
        else:
            p["wi_gate"] = _normal(gen, (D, F), s, device, dt)
            p["wi_up"] = _normal(gen, (D, F), s, device, dt)
            p["wo_ffn"] = _normal(gen, (F, D), deep, device, dt)
        if cfg.qkv_bias:
            p["bq"], p["bk"], p["bv"] = zeros(Hp, dh), zeros(Hkv, dh), \
                zeros(Hkv, dh)
        if cfg.qk_norm:
            p["q_norm"], p["k_norm"] = ones(dh), ones(dh)
        blocks.append(p)
    params = {
        "embed": _normal(gen, (V, D), 0.02, device, dt),
        "blocks": blocks,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (D, V), s, device, dt)
    return params


# ---------------------------------------------------------------------------
# Embedding / head


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens]


def _mask_padded_vocab(logits, cfg: ModelConfig):
    """Padded vocab rows (sharding padding) never win."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    if V == Vp:
        return logits
    keep = torch.arange(Vp, device=logits.device) < V
    return torch.where(keep, logits, torch.full_like(logits, L.NEG_INF))


def _logits(params, cfg: ModelConfig, x):
    """fp32 logits of hidden rows x [B, D], as the reference's einsum with
    ``preferred_element_type=f32``: bf16 operands, fp32 accumulation and
    fp32 output (bf16-rounded logits would drift greedy argmax ties)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if x.is_cuda and x.dtype != f32:
        logits = torch.mm(x, head, out_dtype=f32)
    else:
        logits = x.float() @ head.float()
    return _mask_padded_vocab(logits, cfg)


# ---------------------------------------------------------------------------
# Attention block


def _head_map(cfg: ModelConfig, device):
    """q-head -> kv-head index map (padded q heads -> kv head 0, or h//g
    when kv heads are padded alongside q heads)."""
    H, Hp = cfg.num_heads, cfg.padded_heads
    g = H // cfg.num_kv_heads
    if cfg.padded_kv_heads * g == Hp:
        m = torch.arange(Hp, device=device) // g
    else:
        m = torch.zeros(Hp, dtype=torch.long, device=device)
        m[:H] = torch.arange(H, device=device) // g
    return m


def _qkv(p, xn, cfg: ModelConfig, positions):
    B, S, D = xn.shape
    q = (xn @ p["wq"].reshape(D, -1)).reshape(B, S, cfg.padded_heads, cfg.dh)
    k = (xn @ p["wk"].reshape(D, -1)).reshape(B, S, cfg.padded_kv_heads,
                                                cfg.dh)
    v = (xn @ p["wv"].reshape(D, -1)).reshape(B, S, cfg.padded_kv_heads,
                                                cfg.dh)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(p, o, cfg: ModelConfig):
    B, S = o.shape[:2]
    if cfg.padded_heads != cfg.num_heads:   # zero padded heads (exact)
        keep = torch.arange(cfg.padded_heads, device=o.device) < cfg.num_heads
        o = o * keep[None, None, :, None].to(o.dtype)
    return o.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)


def _kernel_ok(cfg: ModelConfig) -> None:
    if cfg.padded_heads != cfg.num_heads:
        raise ValueError("the attention kernels take no padded heads")


def attn_full(p, x, cfg: ModelConfig, *, pos_offset: int = 0,
              impl: str = "kernel"):
    """Full causal self-attention over x [B,S,D]. Returns (attn_out,
    (k, v)). The kernel takes the un-expanded [B,S,Hkv,dh] K/V and maps
    query heads to KV heads itself (the reference expands first)."""
    _check_impl(impl)
    B, S, _ = x.shape
    positions = pos_offset + torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    _check_family(cfg)
    if impl == "kernel":
        _kernel_ok(cfg)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    else:
        hmap = _head_map(cfg, x.device)
        o = flash_attention_ref(q, L.expand_kv(k, hmap),
                                L.expand_kv(v, hmap), causal=True)
    return _attn_out(p, o.to(x.dtype), cfg), (k, v)


def _decode_attend(q, kd, vd, valid, cfg: ModelConfig):
    """Single-token attention core of the plain dense and paged paths:
    q [B,1,Hp,dh] against kd/vd [B,C,Hkvp,dh] with validity mask [B,C].
    One core for both layouts, as in the reference: masked columns add
    exact zeros, so the two layouts' plain streams agree."""
    B = q.shape[0]
    scale = 1.0 / math.sqrt(cfg.dh)
    Hkvp = cfg.padded_kv_heads
    if cfg.grouped_decode and cfg.can_group_decode:
        # GQA without materializing the expanded KV
        qg = q[:, 0].reshape(B, Hkvp, -1, cfg.dh)
        s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), kd.float()) * scale
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, L.NEG_INF))
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", pr.to(vd.dtype).float(),
                         vd.float())
        return o.reshape(B, 1, cfg.padded_heads, cfg.dh)
    hmap = _head_map(cfg, q.device)
    kr, vr = L.expand_kv(kd, hmap), L.expand_kv(vd, hmap)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, L.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr.to(vr.dtype).float(),
                        vr.float())


def attn_decode(p, x1, cfg: ModelConfig, k_cache, v_cache, pos,
                impl: str = "kernel"):
    """One decode token against the dense layout. x1: [B,1,D] (normed);
    caches [B,C,Hkvp,dh]; pos: [B] int32 per-slot positions. Writes this
    token's K/V at ``min(pos, C-1)`` (in place: the reference returns new
    caches), then attends over the columns ``<= pos``. ``impl="kernel"``
    is kernel 3 with ``lengths = min(pos+1, C)``; ``"plain"`` the shared
    ``_decode_attend`` core."""
    _check_impl(impl)
    B, C = x1.shape[0], k_cache.shape[1]
    q, k, v = _qkv(p, x1, cfg, pos[:, None])
    pos_l = pos.long()
    bidx = torch.arange(B, device=x1.device)
    slot = pos_l.clamp(max=C - 1)
    k_cache.index_put_((bidx, slot), k[:, 0].to(k_cache.dtype))
    v_cache.index_put_((bidx, slot), v[:, 0].to(v_cache.dtype))
    if impl == "kernel":
        _kernel_ok(cfg)
        lengths = (pos_l + 1).clamp(max=C).to(torch.int32)
        o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                             lengths)[:, None]
    else:
        valid = torch.arange(C, device=x1.device)[None, :] <= pos_l[:, None]
        o = _decode_attend(q, k_cache, v_cache, valid, cfg)
    return _attn_out(p, o.to(x1.dtype), cfg), (k_cache, v_cache)


def _chunk_attend(q, kr, vr, mask, cfg: ModelConfig):
    """Mask-based chunk-attention core of the plain dense and paged
    prefill paths: q [B,Sq,Hp,dh] against expanded kr/vr [B,C,Hp,dh] with
    causal mask [Sq,C]."""
    scale = 1.0 / math.sqrt(cfg.dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    s = torch.where(mask[None, None], s, torch.full_like(s, L.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr.to(vr.dtype).float(),
                        vr.float())


def attn_chunk(p, x, cfg: ModelConfig, k_cache, v_cache, kv_offset: int,
               impl: str = "kernel"):
    """Prefill chunk: x [B,Sq,D] (normed) is tokens [off, off+Sq); the
    caches [B,C,Hkvp,dh] hold [0, off) and take this chunk's K/V in place.
    ``impl="kernel"`` runs the flash kernel on the first off+Sq cache rows
    with ``q_offset=off`` (the mask ``kpos <= qpos`` the reference applies
    over all C columns is the kernel's causal mask); ``"plain"`` mirrors
    the reference's mask-based core."""
    _check_impl(impl)
    B, Sq, _ = x.shape
    off = int(kv_offset)
    positions = off + torch.arange(Sq, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    k_cache[:, off:off + Sq] = k.to(k_cache.dtype)
    v_cache[:, off:off + Sq] = v.to(v_cache.dtype)
    if impl == "kernel":
        _kernel_ok(cfg)
        o = flash_attention(q.contiguous(),
                            k_cache[:, :off + Sq].contiguous(),
                            v_cache[:, :off + Sq].contiguous(),
                            causal=True, q_offset=off)
    else:
        hmap = _head_map(cfg, x.device)
        C = k_cache.shape[1]
        qpos = positions[0][:, None]
        mask = torch.arange(C, device=x.device)[None, :] <= qpos
        o = _chunk_attend(q, L.expand_kv(k_cache, hmap),
                          L.expand_kv(v_cache, hmap), mask, cfg)
    return _attn_out(p, o.to(x.dtype), cfg), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# FFN and layer body


def _ffn(p, x, cfg: ModelConfig):
    """The FFN sub-block with its residual: the dense SwiGLU, or the MoE
    FFN where ``cfg.moe`` is set (its metrics dropped, as the reference's
    serving paths drop them)."""
    xn = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        y, _ = moe.moe_ffn(xn, p["moe"], cfg.moe,
                           combine_fp32=cfg.moe_combine_fp32,
                           expert_tp=cfg.moe_expert_tp)
        return x + y
    return x + L.swiglu(xn, p["wi_gate"], p["wi_up"], p["wo_ffn"])


def _layer_prefill(p, x, cfg: ModelConfig, impl: str):
    """One layer over the prompt; returns (x, cache entry): {"k","v":
    [B,S,Hkvp,dh]}, or an RWKV layer's final state."""
    if cfg.block == "rwkv":
        state = rwkv6.init_rwkv_state(cfg, x.shape[0], device=x.device)
        return rwkv6.rwkv_block(p, x, state, cfg, impl=impl)
    xn = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    attn_out, (k, v) = attn_full(p, xn, cfg, impl=impl)
    x = _ffn(p, x + attn_out, cfg)
    return x, {"k": k, "v": v}


def prefill_full(params, cfg: ModelConfig, inputs, *,
                 capacity: Optional[int] = None, impl: str = "kernel"):
    """Single-shot prefill. inputs: {"tokens": [B,S] int}. Returns (logits
    [B,Vp] fp32, cache {"k","v": [L,B,C,Hkvp,dh], "pos": [B]}); for RWKV
    the cache is the state after the prompt, and ``capacity`` is unused."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, inputs["tokens"])
    B, S, _ = x.shape
    capacity = capacity or S
    entries = []
    for p in params["blocks"]:
        x, entry = _layer_prefill(p, x, cfg, impl)
        entries.append(entry)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1])
    cache = {key: torch.stack([e[key] for e in entries])
             for key in _cache_keys(cfg)}
    if cfg.block == "attn" and capacity > S:    # grow to the capacity
        for key in ("k", "v"):
            c = cache[key]
            pad = c.new_zeros(c.shape[:2] + (capacity - S,) + c.shape[3:])
            cache[key] = torch.cat([c, pad], dim=2)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, device):
    """Empty dense cache {"k","v": [L,B,C,Hkvp,dh], "pos": [B] int32}
    (decoding starts at pos 0), or for RWKV the zero state {"s":
    [L,B,H,N,N] fp32, "tm_x", "cm_x": [L,B,D], "pos"} (no capacity): the
    reference's ``init_cache``."""
    _check_family(cfg)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.block == "rwkv":
        state = rwkv6.init_rwkv_state(cfg, cfg.num_layers * batch,
                                      device=device)
        cache = {key: t.reshape((cfg.num_layers, batch) + t.shape[1:])
                 for key, t in state.items()}
        return {**cache, "pos": pos}
    shape = (cfg.num_layers, batch, capacity, cfg.padded_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "pos": pos}


def _cache_keys(cfg: ModelConfig):
    """The per-layer entries of a dense cache (all but ``pos``)."""
    return ("s", "tm_x", "cm_x") if cfg.block == "rwkv" else ("k", "v")


def _layer_decode(p, x1, cfg: ModelConfig, entry, pos, impl: str):
    """One layer of a decode step; ``entry`` is this layer's cache views,
    written in place."""
    if cfg.block == "rwkv":
        x1, _ = rwkv6.rwkv_block_step(p, x1, entry, cfg, impl=impl)
        return x1
    xn = L.rms_norm(x1, p["attn_norm"], cfg.norm_eps)
    attn_out, _ = attn_decode(p, xn, cfg, entry["k"], entry["v"], pos,
                              impl=impl)
    return _ffn(p, x1 + attn_out, cfg)


def decode_step(params, cfg: ModelConfig, cache, tokens,
                impl: str = "kernel"):
    """Batched decode step on the dense layout. tokens: [B]. Returns
    (logits [B,Vp] fp32, cache) with ``pos + 1`` for every slot, as the
    reference (inactive slots advance too; their writes clamp at C-1 and
    nothing live reads them; an RWKV step advances their state, which
    ``insert`` overwrites whole). K/V or the state are updated in place."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])
    pos = cache["pos"]
    keys = _cache_keys(cfg)
    for i, p in enumerate(params["blocks"]):
        x = _layer_decode(p, x, cfg, {key: cache[key][i] for key in keys},
                          pos, impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (_logits(params, cfg, x[:, 0]),
            {**{key: cache[key] for key in keys}, "pos": pos + 1})


def prefill_chunked(params, cfg: ModelConfig, inputs, chunk_size: int, *,
                    capacity: Optional[int] = None, impl: str = "kernel",
                    cache=None, start: int = 0):
    """Chunked (Sarathi-style) prefill on the dense layout: the prompt in
    ``chunk_size`` pieces, the cache carried between chunks. ``cache`` /
    ``start`` resume from a cached prefix (tokens[:, :start] already in the
    cache); that cache is written in place. Returns (logits [B,Vp] fp32 at
    the last input position, cache with ``pos`` = the input length)."""
    _check_attn(cfg, "chunked prefill")
    x = embed_tokens(params, cfg, inputs["tokens"])
    B, S, _ = x.shape
    capacity = capacity or S
    if (S - start) % chunk_size or start % chunk_size:
        raise ValueError(f"prompt {S} / start {start} not in whole chunks "
                         f"of {chunk_size}")
    if S > capacity:
        raise ValueError(f"prompt {S} exceeds the cache capacity {capacity}")
    if cache is None:
        cache = init_cache(cfg, B, capacity, device=x.device)
    out = x[:, :0]
    for lo in range(start, S, chunk_size):
        out = x[:, lo:lo + chunk_size]
        for i, p in enumerate(params["blocks"]):
            xn = L.rms_norm(out, p["attn_norm"], cfg.norm_eps)
            attn_out, _ = attn_chunk(p, xn, cfg, cache["k"][i],
                                     cache["v"][i], lo, impl=impl)
            out = _ffn(p, out + attn_out, cfg)
    out = L.rms_norm(out, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, out[:, -1]), {
        "k": cache["k"], "v": cache["v"],
        "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}


# ---------------------------------------------------------------------------
# Paged KV cache


def supports_paged(cfg: ModelConfig) -> bool:
    """Paged serving covers the dense-attention family without quantized
    KV or a sliding window."""
    return (cfg.block == "attn" and not cfg.kv_quant
            and not cfg.sliding_window)


def init_block_pool(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                    device):
    """Zero-filled block pool {"k","v": [N, Bs, Hkvp, dh]}."""
    shape = (num_blocks, block_size, cfg.padded_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def gather_blocks(pool, ids):
    """ids [L, nb] -> free-floating {"k","v": [L, nb, Bs, Hkvp, dh]}: the
    paged KV-handoff payload (only the request's own blocks travel)."""
    ids = ids.long()
    return {"k": pool["k"][ids], "v": pool["v"][ids]}


def scatter_blocks(pool, ids, blocks):
    """Write handoff block tensors into ``pool`` at ids [L, nb] (distinct
    across layers). In place, where the reference's jit donates the pool."""
    flat = ids.reshape(-1).long()
    for key in ("k", "v"):
        dst = pool[key]
        src = blocks[key].reshape((-1,) + tuple(dst.shape[1:]))
        dst.index_copy_(0, flat, src.to(device=dst.device, dtype=dst.dtype))
    return pool


def attn_decode_paged(p, x1, cfg: ModelConfig, pool_k, pool_v, tbl, pos,
                      impl: str = "kernel"):
    """One decode token against the paged layout. x1: [B,1,D] (normed);
    pool_k/v: [N,Bs,Hkvp,dh]; tbl: [B,nb] int32; pos: [B] int32. Writes
    this token's K/V into the slot's current block (in place: the
    reference donates the pool to jit), then attends over the window
    W = nb*Bs. Inactive slots point at the trash block with pos=0: their
    writes land there, duplicates and all, and nothing live reads it."""
    _check_impl(impl)
    B = x1.shape[0]
    Bs = pool_k.shape[1]
    q, k, v = _qkv(p, x1, cfg, pos[:, None])
    pos_l = pos.long()
    wblk = tbl[torch.arange(B, device=tbl.device), pos_l // Bs].long()
    off = pos_l % Bs
    pool_k.index_put_((wblk, off), k[:, 0].to(pool_k.dtype))
    pool_v.index_put_((wblk, off), v[:, 0].to(pool_v.dtype))
    if impl == "kernel":
        _kernel_ok(cfg)
        o = decode_attention_paged(q[:, 0].contiguous(), pool_k, pool_v, tbl,
                                   pos + 1)[:, None]
    else:
        W = tbl.shape[1] * Bs
        kd = pool_k[tbl.long()].reshape(B, W, cfg.padded_kv_heads, cfg.dh)
        vd = pool_v[tbl.long()].reshape(B, W, cfg.padded_kv_heads, cfg.dh)
        valid = torch.arange(W, device=pos.device)[None, :] <= pos_l[:, None]
        o = _decode_attend(q, kd, vd, valid, cfg)
    return _attn_out(p, o.to(x1.dtype), cfg), (pool_k, pool_v)


def decode_step_paged(params, cfg: ModelConfig, pool, tables, pos, tokens,
                      impl: str = "kernel"):
    """Batched decode step on the paged layout. tables: [L,B,nb] int32;
    pos, tokens: [B]. Returns (logits [B,Vp] fp32, pool, pos+1); the pool
    is updated in place."""
    _check_attn(cfg, "the paged layout")
    x = embed_tokens(params, cfg, tokens[:, None])
    pk, pv = pool["k"], pool["v"]
    for p, tbl in zip(params["blocks"], tables):
        xn = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        attn_out, _ = attn_decode_paged(p, xn, cfg, pk, pv, tbl, pos,
                                        impl=impl)
        x = _ffn(p, x + attn_out, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, 0]), pool, pos + 1


def prefill_chunked_paged(params, cfg: ModelConfig, inputs, chunk_size: int,
                          pool, tables, *, start: int = 0,
                          impl: str = "kernel"):
    """Chunked prefill that appends straight into the request's blocks (no
    dense B=1 cache). B=1; tables: [L, nb] covering the prompt;
    ``chunk_size % block_size == 0`` so every chunk lands on block
    boundaries. ``start`` resumes after a prefix-cache hit (those blocks
    already hold the prefix KV). Each chunk writes its K/V into its blocks
    (in place), gathers the table window and attends: ``impl="kernel"``
    through the flash kernel on the first lo+chunk gathered rows with
    ``q_offset=lo`` and un-expanded GQA (the reference's ``"pallas"``
    branch), ``"plain"`` through the mask-based core over the whole window
    (its ``"xla"`` branch). Returns (logits [1,Vp] fp32, pool)."""
    _check_attn(cfg, "chunked prefill")
    x = embed_tokens(params, cfg, inputs["tokens"])
    B, S, _ = x.shape
    Bs = pool["k"].shape[1]
    Hkvp, dh = cfg.padded_kv_heads, cfg.dh
    nb = tables.shape[1]
    W = nb * Bs
    if B != 1:
        raise ValueError("paged prefill is per request (B=1)")
    if chunk_size % Bs:
        raise ValueError(f"chunk {chunk_size} is not block-aligned ({Bs})")
    if (S - start) % chunk_size or start % chunk_size:
        raise ValueError(f"prompt {S} / start {start} not in whole chunks "
                         f"of {chunk_size}")
    if S > W:
        raise ValueError(f"prompt {S} exceeds the table window {W}")
    cb = chunk_size // Bs
    pk, pv = pool["k"], pool["v"]
    hmap = _head_map(cfg, x.device)
    out = x[:, :0]
    for lo in range(start, S, chunk_size):
        out = x[:, lo:lo + chunk_size]
        positions = lo + torch.arange(chunk_size, device=x.device)[None, :]
        ctx = lo + chunk_size
        for p, tbl in zip(params["blocks"], tables):
            xn = L.rms_norm(out, p["attn_norm"], cfg.norm_eps)
            q, k, v = _qkv(p, xn, cfg, positions)
            wids = tbl[lo // Bs:lo // Bs + cb].long()
            pk.index_copy_(0, wids, k[0].reshape(cb, Bs, Hkvp, dh).to(pk.dtype))
            pv.index_copy_(0, wids, v[0].reshape(cb, Bs, Hkvp, dh).to(pv.dtype))
            if impl == "kernel":
                _kernel_ok(cfg)
                live = tbl[:ctx // Bs].long()
                o = flash_attention(q.contiguous(),
                                    pk[live].reshape(1, ctx, Hkvp, dh),
                                    pv[live].reshape(1, ctx, Hkvp, dh),
                                    causal=True, q_offset=lo)
            else:
                kd = pk[tbl.long()].reshape(1, W, Hkvp, dh)
                vd = pv[tbl.long()].reshape(1, W, Hkvp, dh)
                mask = (torch.arange(W, device=x.device)[None, :]
                        <= positions[0][:, None])
                o = _chunk_attend(q, L.expand_kv(kd, hmap),
                                  L.expand_kv(vd, hmap), mask, cfg)
            out = _ffn(p, out + _attn_out(p, o.to(out.dtype), cfg), cfg)
    out = L.rms_norm(out, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, out[:, -1]), pool
