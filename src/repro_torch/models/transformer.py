"""The decoder of ``repro.models.transformer`` in PyTorch: the dense
attention family, MoE, the attention-free RWKV-6 family, the hybrid
family and the jamba family, with llava's vision frontend and the
training loss.

Parameters keep the reference's names and layouts (``wq`` [D,Hp,dh],
``wo`` [Hp,dh,D], ...), with ``params["blocks"]`` a list of per-layer
dicts: the layer loop is a Python loop where the reference scans a stacked
``[L, ...]`` axis (``convert.py`` turns one into the other).

Every function that attends takes ``impl``: ``"kernel"`` runs the
hand-written CUDA kernels of ``repro_torch.kernels`` (on a CPU tensor their
wrappers run the plain version), ``"plain"`` runs the plain PyTorch
versions on any device. The serving engine picks ``"kernel"`` on CUDA.
``"xla"`` is the reference's default lowering: ``"plain"``, but with a
whole prompt's attention (``attn_full``) the blocked online softmax
(``layers.causal_attention_xla``, banded under a sliding window) in place
of the kernel's plain version and its whole score tensor. The training
forward and the dry run run it. A prompt's SSM scan (the hybrid and jamba
families, ``ssm._prompt_scan``) follows ``impl`` too: ``"kernel"`` is the
selective-scan kernel, one launch a layer; a decode step's one position
is plain PyTorch whatever ``impl``.

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

**One table of layer kinds.** Layer i's kind is ``ModelConfig.mixer(i)``
and ``MIXERS`` holds all that depends on it: its span, its pre-norm, the
K/V and recurrent state it keeps per slot, its mixer (a prompt from zero
state, or one token against its state's views) and the layouts and paths
it takes (``supports_paged``, ``supports_chunked``, dense, training).
Every path runs one layer body, ``_layer``: the mixer with its residual,
then the FFN (``_ffn_aux``: the SwiGLU, or the reference's MoE,
``models/moe.py``, whose metrics the serving paths drop, as the
reference's do). The paths differ only in how the layer attends (a whole
prompt, a dense row, a chunk, the paged pool through a block table) and
the state they hand it, each entry stacked over the layers that keep it
(``cache_stacks``). The kinds:

- ``"attn"`` (``block="attn"``), the only one that takes chunked prefill:
  an RWKV, hybrid or Mamba-1 prompt runs whole (its recurrence is already
  chunked inside its scan).
- ``"rwkv"`` (``block="rwkv"``, ``models/rwkv6.py``): the RWKV-6 block.
  Its dense "cache" is the recurrent state alone, O(1) per request (no
  capacity, nothing to page). Every WKV runs through the WKV kernel under
  ``impl="kernel"``.
- ``"hybrid"`` (``block="hybrid"``, hymba-1.5b): attention and a selective
  SSM (``models/ssm.py``) side by side on the same normed input, their
  normed outputs averaged. With a sliding window W its attention is
  banded (the flash kernel's ``window``) and its K/V a ring of W rows,
  token ``pos`` in row ``pos % W``: a prefill hands over that ring and
  the SSM state, whatever the prompt's length, and there is nothing to
  page.
- ``"mamba"``: Jamba's Mamba-1 mixer (``ssm.mamba_apply`` /
  ``mamba_step``). A ``block="jamba"`` model (AI21's Jamba) attends,
  without position encoding where ``cfg.rope`` is False, in the layers
  ``i % attn_layer_period == attn_layer_offset`` and runs Mamba-1 in the
  others, the MoE FFN in its expert layers (``has_experts``). It serves
  on the paged layout only, its pool and block tables over its attention
  layers and each slot's SSM state beside them (``init_slot_state``),
  and does not train.

kv-quant (``cfg.kv_quant``) stores the dense cache as int8 with a bf16
scale per token and KV head (``k_scale``/``v_scale`` [L,B,C,Hkvp]), as
the reference's ``_kv_quantize``: a prefill attends over the unquantized
K/V and quantizes only its cache entry, a decode step quantizes its own
row and attends over the dequantized cache (on the card: kernel 3 reads
the dequantized copy, as the reference dequantizes, then attends). It has
no paged layout and no chunked prefill, as in the reference.

``verify_chunk`` scores k tokens at once against a dense cache (the
speculative-decoding verify pass, ``serving/speculative.py``); on the card
it is the flash kernel at ``q_offset``.

The vision frontend (llava-next) projects precomputed patch embeddings
[B,P,vision_dim] through a 2-layer GELU MLP (``params["vis_proj"]``) and
prepends them to the token embeddings (``embed_inputs``). Every entry that
takes a prompt (``prefill_full``, ``prefill_chunked``,
``prefill_chunked_paged``, ``verify_chunk``, ``forward_hidden``) embeds
through it, as the reference; decode steps embed tokens only. The serving
engine, like the reference's, feeds tokens only, so a served llava runs
its backbone on text.

``train_loss`` is the reference's causal LM loss (chunked cross-entropy,
the MoE loss terms, ``cfg.remat`` as ``torch.utils.checkpoint`` per
layer). It runs no hand-written kernel: none has a backward, in the
reference either (its training attention is XLA's blocked online softmax,
``layers.causal_attention_xla``, here in plain, differentiable PyTorch).

A sliding window on the attn block comes with a later slice
(``unported`` says so).

Under a ``torch.profiler`` session every layer is two spans on the
profiler's clock (``serving.tracing.span``), opened by ``_layer``: its
mixer's (``repro_torch.model.mixer``: the attention norm through the
residual add, or the RWKV block; ``repro_torch.model.ssm`` for a Mamba-1
layer's norm through its residual add and the step's state write) and
``repro_torch.model.ffn`` or ``.moe`` (``_ffn_aux``: its norm through its
residual add), with ``repro_torch.model.logits`` around the serving
paths' head. With no profiler running a span is one check.

``decode_step_paged`` takes an engine's CUDA graphs (``graphs=``,
``serving/graphs.py``): on the card under ``impl="kernel"`` it replays
the graph of its inputs' shapes, captured from its eager body
(``_decode_step_paged_eager``) on the first step at those shapes.
"""
from __future__ import annotations

import functools
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                     decode_attention_paged)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import moe, rwkv6, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (constrain, current_mesh,
                                           mesh_coordinate, mesh_dims, pin,
                                           placements_for,
                                           shard_map_placements)
from repro_torch.serving.tracing import span

f32 = torch.float32
IMPLS = ("kernel", "plain", "xla")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot run on the port yet (the slice that brings it),
    or None for the families it covers: dense attention (with the vision
    frontend or none), MoE, RWKV-6, the hybrid family (with or without
    its sliding window) and the jamba family, with or without kv-quant on
    the attn block."""
    if cfg.block not in ("attn", "rwkv", "hybrid", "jamba"):
        return f"{cfg.block} blocks are no family of the reference"
    if cfg.block == "jamba":
        if not cfg.ssm_dt_rank:
            return "a jamba model's Mamba-1 mixer needs ssm_dt_rank"
        if cfg.sliding_window or cfg.kv_quant:
            return "a jamba model attends over all positions, in bf16"
        return None
    if cfg.block == "rwkv":         # its own channel mix; no KV to quantize
        return None
    if cfg.kv_quant and cfg.block != "attn":
        # the reference's hybrid prefill keeps its ring unquantized while
        # its cache and decode step quantize: no model of its own to port
        return "kv-quant is defined on the attn block only"
    if cfg.sliding_window and cfg.block == "attn":
        # no configuration reaches the attn block's windowed chunked and
        # paged paths, in the reference either
        return ("a sliding window on the attn block comes with a later "
                "slice")
    return None


def _check_family(cfg: ModelConfig) -> None:
    why = unported(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why}")


def _takes(cfg: ModelConfig, path: str) -> bool:
    """Every layer's mixer takes ``path`` (``_Mixer.paths``)."""
    return all(cfg.mixer(i) in MIXERS and path in MIXERS[cfg.mixer(i)].paths
               for i in range(cfg.num_layers))


def _check_takes(cfg: ModelConfig, path: str, what: str) -> None:
    """``what`` needs every mixer to take ``path`` and a bf16 cache (the
    reference writes int8 only in whole prefills and decode steps)."""
    _check_family(cfg)
    if not _takes(cfg, path):
        raise ValueError(f"{cfg.name}: {what} is for the attention family "
                         f"only, not {cfg.block} blocks")
    if cfg.kv_quant:
        raise ValueError(f"{cfg.name}: {what} keeps a bf16 KV cache; "
                         "kv-quant runs on whole prefills and dense decode "
                         "steps only")


# ---------------------------------------------------------------------------
# Init


def _normal(gen, shape, std, device, dtype):
    """N(0, std^2) drawn in fp32 on ``device``, then cast (the reference's
    ``(normal(f32) * std).astype(dt)``); on the meta device a shape and a
    dtype only (``gen`` is None there)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=f32, device=device)
    return (x * std).to(dtype)


def _generator(device: torch.device, seed: int):
    """A seeded generator on ``device``; None on the meta device, which
    has none and draws nothing."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _init_moe(gen, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """The reference's MoE FFN init (``_init_ffn_layer``): an fp32 router
    of std 0.02, experts ``wg``/``wu`` [E,D,F] and ``wd`` [E,F,D] of std
    1/sqrt(D) (``wd`` also over sqrt(L)), and the shared experts' SwiGLU
    [D,F*n] / [F*n,D] where the config has any."""
    m, D, dt = cfg.moe, cfg.d_model, cfg.tdtype
    E, F = m.num_experts, m.d_ff_expert
    s = 1.0 / math.sqrt(D)
    p = {"router": _normal(gen, (D, m.routed), 0.02, device, f32),
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
    layer's FFN under ``p["moe"]``; a hybrid layer's SSM under
    ``p["ssm"]`` with its two output norms; a jamba Mamba-1 layer's mixer
    under ``p["ssm"]`` (``ssm.init_mamba``) with its norm ``ssm_norm`` in
    place of the attention's; a vision configuration's
    ``vis_proj`` w1 [vision_dim,D] and w2 [D,D] of std 1/sqrt(vision_dim)
    and 1/sqrt(D)), drawn from a ``torch.Generator`` on ``device``. The
    numbers differ from ``jax.random``'s; tests that need both packages on
    the same weights convert the JAX ones (``repro_torch.convert``). On
    ``device="meta"`` it draws nothing (``abstract_params``)."""
    _check_family(cfg)
    device = torch.device(device)
    gen = _generator(device, seed)
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
    for i in range(cfg.num_layers):
        kind = cfg.mixer(i)
        if kind == "rwkv":
            blocks.append(rwkv6.init_rwkv_block(gen, cfg, device=device))
            continue
        if kind == "mamba":
            p = {"ssm_norm": ones(D),
                 "ssm": ssm.init_mamba(gen, cfg, device=device),
                 "ffn_norm": ones(D)}
        else:
            p = {
                "attn_norm": ones(D),
                "wq": _normal(gen, (D, Hp, dh), s, device, dt),
                "wk": _normal(gen, (D, Hkv, dh), s, device, dt),
                "wv": _normal(gen, (D, Hkv, dh), s, device, dt),
                "wo": _normal(gen, (Hp, dh, D), deep, device, dt),
                "ffn_norm": ones(D),
            }
        if cfg.has_experts(i):
            p["moe"] = _init_moe(gen, cfg, device)
        else:
            p["wi_gate"] = _normal(gen, (D, F), s, device, dt)
            p["wi_up"] = _normal(gen, (D, F), s, device, dt)
            p["wo_ffn"] = _normal(gen, (F, D), deep, device, dt)
        if cfg.qkv_bias and "wq" in p:
            p["bq"], p["bk"], p["bv"] = zeros(Hp, dh), zeros(Hkv, dh), \
                zeros(Hkv, dh)
        if cfg.qk_norm and "wq" in p:
            p["q_norm"], p["k_norm"] = ones(dh), ones(dh)
        if kind == "hybrid":
            p["ssm"] = ssm.init_ssm(gen, cfg, device=device)
            p["attn_out_norm"], p["ssm_out_norm"] = ones(D), ones(D)
        blocks.append(p)
    params = {
        "embed": _normal(gen, (V, D), 0.02, device, dt),
        "blocks": blocks,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (D, V), s, device, dt)
    if cfg.frontend == "vision":
        vd = cfg.vision_dim
        params["vis_proj"] = {
            "w1": _normal(gen, (vd, D), 1.0 / math.sqrt(vd), device, dt),
            "w2": _normal(gen, (D, D), s, device, dt)}
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``'s tree on the meta device: every leaf's shape and
    dtype, no storage (the reference's ``jax.eval_shape`` of its init; the
    dry-run path)."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# Embedding / head


def _sharded(x) -> bool:
    """True for a DTensor under a device mesh (``use_mesh``)."""
    return current_mesh() is not None and isinstance(x, DTensor)


def _embed_sharded(table, tokens):
    """The embedding lookup on a vocab-sharded table: each rank looks up
    the tokens that fall in its rows (zeros elsewhere) and the ranks'
    rows are summed (a partial over the vocab axes), where indexing would
    gather the whole table. Tokens keep their batch layout; an FSDP split
    of the table's width is gathered first."""
    mesh = current_mesh()
    t_pl = placements_for(table.shape, "vocab", None)
    x_pl = placements_for(tokens.shape, "dp", *(None,) * (tokens.dim() - 1))
    vocab_dims = mesh_dims(mesh, t_pl, 0)
    out_pl = tuple(Partial() if i in vocab_dims else x_pl[i]
                   for i in range(mesh.ndim))

    def local(table, tokens):
        n = table.shape[0]
        rel = tokens.long() - mesh_coordinate(mesh, vocab_dims) * n
        ok = (rel >= 0) & (rel < n)
        rows = table[rel.clamp(0, n - 1)]
        return torch.where(ok[..., None], rows, torch.zeros_like(rows))

    return shard_map_placements(local, (table, tokens), (t_pl, x_pl), out_pl)


def embed_tokens(params, cfg: ModelConfig, tokens):
    if _sharded(params["embed"]):
        out = _embed_sharded(params["embed"], tokens)
    else:
        out = params["embed"][tokens]
    return constrain(out, "dp", None, None)


def embed_inputs(params, cfg: ModelConfig, inputs: Dict[str, Any]):
    """Returns ([B,S,D] embeddings, loss mask [B,S] or None). With the
    vision frontend and ``inputs["patch_embeds"]`` [B,P,vision_dim], the
    P projected patches come first and the mask is False over them: the
    projection is ``gelu(pe @ w1) @ w2`` with the GELU in fp32 and its tanh
    form (``jax.nn.gelu``'s default; ``F.gelu``'s is the erf form)."""
    tok_emb = embed_tokens(params, cfg, inputs["tokens"])
    if cfg.frontend != "vision" or "patch_embeds" not in inputs:
        return tok_emb, None
    w = params["vis_proj"]
    pe = inputs["patch_embeds"].to(cfg.tdtype)
    h = F.gelu((pe @ w["w1"]).float(), approximate="tanh").to(cfg.tdtype)
    vis = constrain(h @ w["w2"], "dp", None, None)
    B, P = vis.shape[:2]
    mask = torch.cat([torch.zeros((B, P), dtype=torch.bool, device=vis.device),
                      torch.ones(tok_emb.shape[:2], dtype=torch.bool,
                                 device=vis.device)], dim=1)
    return torch.cat([vis, tok_emb], dim=1), mask


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

    def product(x, head):
        if x.is_cuda and x.dtype != f32:
            return torch.mm(x, head, out_dtype=f32)
        return x.float() @ head.float()

    with span("repro_torch.model.logits"):
        if _sharded(head):  # rows over dp, vocab over tp: each rank's block
            mesh = current_mesh()
            x_pl = placements_for(x.shape, "dp", None)
            h_pl = placements_for(head.shape, None, "vocab")
            out_pl = tuple(Shard(1) if p == Shard(1) else x_pl[i]
                           for i, p in enumerate(h_pl))
            logits = shard_map_placements(product, (x, head), (x_pl, h_pl),
                                          out_pl)
        else:
            logits = product(x, head)
        return constrain(_mask_padded_vocab(logits, cfg), "dp", "vocab")


# ---------------------------------------------------------------------------
# KV-cache quantization (int8 values + per-token-per-head bf16 scales)


def _kv_quantize(row):
    """[..., dh] -> (int8 [..., dh], bf16 scale [...]), as the reference:
    the values divided by the fp32 scale max(amax / 127, 1e-8), rounded
    half to even and clipped to +-127; the scale then stored in bf16."""
    r = row.float()
    scale = torch.clamp(r.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(r / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _kv_dequant(vals, scales, dtype):
    return (vals.float() * scales.float()[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Attention block


_HEADS = ("dp", None, "tp", None)      # [B,S,H,dh]: batch dp, heads tp
_ROWS = ("dp", None, None, None)       # [B,S,Hkv,dh]: batch dp


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
    D = xn.shape[-1]
    q = L.split_heads(L.linear(xn, pin(p["wq"].reshape(D, -1))),
                      cfg.padded_heads, cfg.dh)
    k = L.split_heads(L.linear(xn, pin(p["wk"].reshape(D, -1))),
                      cfg.padded_kv_heads, cfg.dh)
    v = L.split_heads(L.linear(xn, pin(p["wv"].reshape(D, -1))),
                      cfg.padded_kv_heads, cfg.dh)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, None, None)
    v = constrain(v, "dp", None, None, None)
    return q, k, v


def _attn_out(p, o, cfg: ModelConfig):
    B, S = o.shape[:2]
    if cfg.padded_heads != cfg.num_heads:   # zero padded heads (exact)
        keep = torch.arange(cfg.padded_heads, device=o.device) < cfg.num_heads
        o = o * keep[None, None, :, None].to(o.dtype)
    out = L.linear(o.reshape(B, S, -1), pin(p["wo"].reshape(-1, cfg.d_model)))
    return constrain(out, "dp", None, None)


def _local_heads(core, q, k, v, hmap):
    """``core(q, kr, vr)`` over q [B,S,Hp,dh] and K/V [B,S,Hkvp,dh]
    expanded to the query heads by ``hmap``. Under a mesh it runs on each
    rank's batch and query heads (``shard_map``), expanding its KV heads
    locally from its slice of the head map: DTensor can carry neither two
    sharded batch dims into one product nor the expansion's backward."""
    if not _sharded(q):
        return core(q, L.expand_kv(k, hmap), L.expand_kv(v, hmap))
    mesh = current_mesh()
    q_pl = placements_for(q.shape, *_HEADS)
    kv_pl = placements_for(k.shape, *_ROWS)

    def local(q, k, v):
        n = q.shape[2]
        lo = mesh_coordinate(mesh, mesh_dims(mesh, q_pl, 2)) * n
        hm = hmap[lo:lo + n]
        return core(q, *(torch.index_select(t, 2, hm) for t in (k, v)))

    return shard_map_placements(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl)


def _kernel_ok(cfg: ModelConfig) -> None:
    if cfg.padded_heads != cfg.num_heads:
        raise ValueError("the attention kernels take no padded heads")


def attn_full(p, x, cfg: ModelConfig, *, pos_offset: int = 0,
              impl: str = "kernel"):
    """Full causal self-attention over x [B,S,D], banded to
    ``cfg.sliding_window`` keys where the config has one. Returns
    (attn_out, (k, v)). The kernel takes the un-expanded [B,S,Hkv,dh] K/V
    and maps query heads to KV heads itself (the reference expands
    first)."""
    _check_impl(impl)
    B, S, _ = x.shape
    positions = pos_offset + torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    _check_family(cfg)
    if impl == "kernel":
        _kernel_ok(cfg)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=cfg.sliding_window)
    else:
        W = cfg.sliding_window
        if impl == "plain":
            core = functools.partial(flash_attention_ref, causal=True,
                                     window=W)
        elif W:
            core = functools.partial(L.sliding_window_attention_xla,
                                     window=W)
        else:
            core = L.causal_attention_xla
        o = _local_heads(core, q, k, v, _head_map(cfg, x.device))
    return _attn_out(p, o.to(x.dtype), cfg), (k, v)


def _softmax_pv(s, v, dims, merge=()):
    """softmax(s) @ v over the last axis of s [..., K] and the K rows of v
    (``dims`` the einsum), p rounded to v's dtype first. ``merge``: the
    mesh groups that split K (a context-parallel decode): the max and the
    sum of the softmax are reduced over them first, each rank's share of
    the product after -- the same softmax, in another order of
    additions."""
    if merge:
        m = s.amax(dim=-1, keepdim=True)
        for g in merge:
            m = funcol.all_reduce(m, "max", g)
        e = torch.exp(s - m)
        tot = e.sum(dim=-1, keepdim=True)
        for g in merge:
            tot = funcol.all_reduce(tot, "sum", g)
        pr = e / tot
    else:
        pr = torch.softmax(s, dim=-1)
    o = torch.einsum(dims, pr.to(v.dtype).float(), v.float())
    for g in merge:
        o = funcol.all_reduce(o, "sum", g)
    return o


def _decode_core(q, kd, vd, valid, cfg: ModelConfig, merge=()):
    B = q.shape[0]
    scale = 1.0 / math.sqrt(cfg.dh)
    if cfg.grouped_decode and cfg.can_group_decode:
        # GQA without materializing the expanded KV
        qg = q[:, 0].reshape(B, kd.shape[2], -1, cfg.dh)
        s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), kd.float()) * scale
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, L.NEG_INF))
        o = _softmax_pv(s, vd, "bhgk,bkhd->bhgd", merge)
        return o.reshape(B, 1, -1, cfg.dh)
    hmap = _head_map(cfg, q.device)
    kr, vr = L.expand_kv(kd, hmap), L.expand_kv(vd, hmap)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, L.NEG_INF))
    return _softmax_pv(s, vr, "bhqk,bkhd->bqhd", merge)


def _decode_attend(q, kd, vd, valid, cfg: ModelConfig):
    """Single-token attention core of the plain dense and paged paths:
    q [B,1,Hp,dh] against kd/vd [B,C,Hkvp,dh] with validity mask [B,C].
    One core for both layouts, as in the reference: masked columns add
    exact zeros, so the two layouts' plain streams agree.

    Under a mesh it runs on each rank's shard of the cache, laid out as
    the cache is (``specs.cache_shardings``): batch over the data axes
    where it divides them, and KV heads over the model axis where they
    divide it, else the *sequence* -- the reference's context-parallel
    decode attention, its partial softmaxes merged over the axes that
    split the sequence."""
    if not _sharded(kd):
        return _decode_core(q, kd, vd, valid, cfg)
    mesh = current_mesh()
    kv_pl = tuple(kd.placements)
    grouped = cfg.grouped_decode and cfg.can_group_decode
    if mesh_dims(mesh, kv_pl, 2) and not grouped:
        # the expanded path's head map is the whole model's
        kv_pl = tuple(Replicate() if pl == Shard(2) else pl for pl in kv_pl)
    q_pl = tuple(pl if pl in (Shard(0), Shard(2)) else Replicate()
                 for pl in kv_pl)
    valid_pl = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate()
                     for pl in kv_pl)
    merge = tuple((mesh, i) for i in mesh_dims(mesh, kv_pl, 1))
    return shard_map_placements(
        lambda q, kd, vd, valid: _decode_core(q, kd, vd, valid, cfg, merge),
        (q, kd, vd, valid), (q_pl, kv_pl, kv_pl, valid_pl), q_pl)


def _write_row(cache, at, row):
    """cache[b, slot[b]] = row[b] for every b, in place, ``at`` being
    (arange(B), slot). Under a mesh an elementwise select over the row's
    position mask, which DTensor shards whatever dims the cache splits
    (``index_put_`` has no sharded form)."""
    if not _sharded(cache):
        cache.index_put_(at, row.to(cache.dtype))
        return
    slot = at[1]
    hit = torch.arange(cache.shape[1], device=row.device)[None, :] == \
        slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
    cache.copy_(torch.where(hit, row[:, None].to(cache.dtype), cache))


def attn_decode(p, x1, cfg: ModelConfig, k_cache, v_cache, pos,
                impl: str = "kernel", scales=None):
    """One decode token against the dense layout. x1: [B,1,D] (normed);
    caches [B,C,Hkvp,dh]; pos: [B] int32 per-slot positions. Writes this
    token's K/V (in place: the reference returns new caches) at
    ``min(pos, C-1)``, or, for a sliding window W over a ring of C = W
    rows, at ``pos % W``; then attends over the positions ``<= pos`` (and
    ``> pos - W``). ``impl="kernel"`` is kernel 3 with ``lengths =
    min(pos+1, C)``: on the ring every slot below that length holds one of
    the window's positions, and the softmax does not depend on the slots'
    order. ``"plain"`` is the shared ``_decode_attend`` core under the
    reference's position mask. Under kv-quant the caches are int8 and
    ``scales`` holds ``k_scale``/``v_scale`` [B,C,Hkvp]: the row is
    quantized into them (in place) and both paths attend over the whole
    cache dequantized to x1's dtype, as the reference."""
    _check_impl(impl)
    B, C = x1.shape[0], k_cache.shape[1]
    W = cfg.sliding_window
    if W and C != W:
        raise ValueError(f"{cfg.name}: a sliding window of {W} decodes over "
                         f"a ring of {W} rows, not {C}")
    q, k, v = _qkv(p, x1, cfg, pos[:, None])
    pos_l = pos.long()
    slot = pos_l % C if W else pos_l.clamp(max=C - 1)
    at = (torch.arange(B, device=x1.device), slot)
    if cfg.kv_quant:
        for t, cache, key in ((k, k_cache, "k_scale"),
                              (v, v_cache, "v_scale")):
            vals, sc = _kv_quantize(t[:, 0])
            _write_row(cache, at, vals)
            _write_row(scales[key], at, sc)
        kd = _kv_dequant(k_cache, scales["k_scale"], x1.dtype)
        vd = _kv_dequant(v_cache, scales["v_scale"], x1.dtype)
    else:
        _write_row(k_cache, at, k[:, 0])
        _write_row(v_cache, at, v[:, 0])
        kd, vd = k_cache, v_cache
    if impl == "kernel":
        _kernel_ok(cfg)
        lengths = (pos_l + 1).clamp(max=C).to(torch.int32)
        o = decode_attention(q[:, 0].contiguous(), kd, vd, lengths)[:, None]
    else:
        # each column's position: slot c of the ring holds the latest
        # position <= pos that is c modulo C
        kpos = torch.arange(C, device=x1.device)[None, :]
        if W:
            kpos = pos_l[:, None] - (pos_l[:, None] - kpos) % C
        valid = (kpos <= pos_l[:, None]) & (kpos >= 0)
        if W:
            valid &= kpos > pos_l[:, None] - W
        o = _decode_attend(q, kd, vd, valid, cfg)
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


def _attend_chunk(p, x, cfg: ModelConfig, q, off: int, kv_rows,
                  impl: str):
    """Queries q [B,Sq,Hp,dh] at positions [off, off+Sq) against K and V
    [B,n,Hkvp,dh] of the first n cache positions, ``kv_rows(n)`` (all for
    None): the flash kernel on the first off+Sq at ``q_offset=off``, its
    causal mask the reference's ``kpos <= qpos``, under ``"kernel"``;
    the reference's mask-based core over all of them otherwise."""
    Sq = q.shape[1]
    if impl == "kernel":
        _kernel_ok(cfg)
        k, v = kv_rows(off + Sq)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, q_offset=off)
    else:
        k, v = kv_rows(None)
        hmap = _head_map(cfg, x.device)
        qpos = off + torch.arange(Sq, device=x.device)[:, None]
        mask = torch.arange(k.shape[1], device=x.device)[None, :] <= qpos
        o = _chunk_attend(q, L.expand_kv(k, hmap), L.expand_kv(v, hmap), mask,
                          cfg)
    return _attn_out(p, o.to(x.dtype), cfg)


def attn_chunk(p, x, cfg: ModelConfig, k_cache, v_cache, kv_offset: int,
               impl: str = "kernel"):
    """Prefill chunk: x [B,Sq,D] (normed) is tokens [off, off+Sq); the
    caches [B,C,Hkvp,dh] hold [0, off) and take this chunk's K/V in place;
    then ``_attend_chunk`` over them."""
    _check_impl(impl)
    Sq = x.shape[1]
    off = int(kv_offset)
    q, k, v = _qkv(p, x, cfg, off + torch.arange(Sq, device=x.device)[None])
    k_cache[:, off:off + Sq] = k.to(k_cache.dtype)
    v_cache[:, off:off + Sq] = v.to(v_cache.dtype)
    def rows(n):
        return k_cache[:, :n], v_cache[:, :n]

    return _attend_chunk(p, x, cfg, q, off, rows, impl), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# FFN, the table of mixers and the layer body


def _ffn_aux(p, x, cfg: ModelConfig):
    """The FFN sub-block with its residual: the dense SwiGLU, or the MoE
    FFN where the layer has one (``p["moe"]``: every layer where
    ``cfg.moe`` is set, but in a jamba model). Returns (x, the MoE metrics
    or {})."""
    with span("repro_torch.model.moe" if "moe" in p
              else "repro_torch.model.ffn"):
        xn = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        if "moe" in p:
            y, aux = moe.moe_ffn(xn, p["moe"], cfg.moe,
                                 combine_fp32=cfg.moe_combine_fp32,
                                 expert_tp=cfg.moe_expert_tp)
            return x + y, aux
        return x + L.swiglu(xn, p["wi_gate"], p["wi_up"], p["wo_ffn"]), {}


def _ring(t, W: int):
    """A prompt's K or V [B,S,Hkvp,dh] -> the W-row ring [B,W,Hkvp,dh]:
    position ``pos`` in slot ``pos % W`` (the last W positions rolled by
    ``(S - W) % W``), or zero-padded to W rows when S < W."""
    B, S = t.shape[:2]
    if S >= W:
        return torch.roll(t[:, S - W:], shifts=(S - W) % W, dims=1)
    return torch.cat([t, t.new_zeros((B, W - S) + t.shape[2:])], dim=1)


def _recur(step, apply, p, xn, cfg: ModelConfig, st, impl: str):
    """An SSM (``ssm.ssm_*``, ``ssm.mamba_*``): a token from the views in
    ``st`` or a prompt from zeros. Returns (y, the new state)."""
    if "ssm_h" in st:
        y, s = step(p["ssm"], xn, {"h": st["ssm_h"], "conv": st["conv"]},
                    cfg)
    else:
        y, s = apply(p["ssm"], xn, ssm.init_ssm_state(
            cfg, xn.shape[0], device=xn.device), cfg, impl=impl)
    return y, {"ssm_h": s["h"], "conv": s["conv"]}


def _mix_hybrid(p, xn, cfg: ModelConfig, st, attend, impl: str):
    """Attention beside the SSM on one normed input: their normed mean."""
    y = attend(p, xn, cfg, st)
    s, state = _recur(ssm.ssm_step, ssm.ssm_apply, p, xn, cfg, st, impl)
    return 0.5 * (L.rms_norm(y, p["attn_out_norm"], cfg.norm_eps)
                  + L.rms_norm(s, p["ssm_out_norm"], cfg.norm_eps)), state


def _mix_rwkv(p, x, cfg: ModelConfig, st, attend, impl: str):
    """The RWKV-6 block: a token steps ``st``'s views; a prompt runs from 0."""
    if st:
        return rwkv6.rwkv_block_step(p, x, st, cfg, impl=impl)[0], {}
    return rwkv6.rwkv_block(p, x, rwkv6.init_rwkv_state(
        cfg, x.shape[0], device=x.device), cfg, impl=impl)


def _ssm_zeros(cfg: ModelConfig, rows: int, *, device):
    s = ssm.init_ssm_state(cfg, rows, device=device)
    return {"ssm_h": s["h"], "conv": s["conv"]}


class _Mixer(NamedTuple):
    """One kind of layer mixer (``ModelConfig.mixer``)."""
    span: str               # its profiler span, norm through residual
    norm: Optional[str]     # its pre-norm's key; None: the whole block
    attends: bool           # it keeps K/V (``_kv_keys``)
    state: Tuple[str, ...]  # the recurrent state it keeps per slot
    zeros: Optional[Callable]   # (cfg, rows, *, device) -> it, zero
    mix: Callable           # (p, xn, cfg, st, attend, impl) -> (y, state)
    paths: Tuple[str, ...]  # the layouts and paths it takes


MIXERS: Dict[str, _Mixer] = {
    "attn": _Mixer("repro_torch.model.mixer", "attn_norm", True, (), None,
                   lambda p, xn, cfg, st, attend, impl: (
                       attend(p, xn, cfg, st), {}),
                   ("dense", "paged", "chunked", "train")),
    "rwkv": _Mixer("repro_torch.model.mixer", None, False,
                   ("s", "tm_x", "cm_x"), rwkv6.init_rwkv_state, _mix_rwkv,
                   ("dense", "train")),
    "hybrid": _Mixer("repro_torch.model.mixer", "attn_norm", True,
                     ("ssm_h", "conv"), _ssm_zeros, _mix_hybrid,
                     ("dense", "train")),
    "mamba": _Mixer("repro_torch.model.ssm", "ssm_norm", False,
                    ("ssm_h", "conv"), _ssm_zeros,
                    lambda p, xn, cfg, st, attend, impl: _recur(
                        ssm.mamba_step, ssm.mamba_apply, p, xn, cfg, st,
                        impl), ("paged",)),
}


def _layer(p, x, cfg: ModelConfig, kind: str, st, attend, impl: str):
    """The one layer body: ``kind``'s mixer with its residual, then the
    FFN (none after a whole block). ``st``: views of the layer's state,
    written in place, or for a prompt none (it runs from zeros, and
    ``st`` takes the layer's cache entries). Returns (x, MoE metrics)."""
    m = MIXERS[kind]
    with span(m.span):
        if m.norm is None:
            x, new = m.mix(p, x, cfg, st, attend, impl)
        else:
            y, new = m.mix(p, L.rms_norm(x, p[m.norm], cfg.norm_eps), cfg,
                           st, attend, impl)
            x = x + y
        for key, t in new.items():
            if key in st:
                st[key].copy_(t)
            else:
                st[key] = t
    if m.norm is None:
        return x, {}
    return _ffn_aux(p, x, cfg)


def _kv_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    return ("k", "v") + (("k_scale", "v_scale") if cfg.kv_quant else ())


def cache_stacks(cfg: ModelConfig) -> Dict[str, int]:
    """A prefill's or dense cache's entries but ``pos``, each with the
    number of layers it stacks over: those that keep it."""
    n: Dict[str, int] = {}
    for i in range(cfg.num_layers):
        m = MIXERS[cfg.mixer(i)]
        for key in (_kv_keys(cfg) if m.attends else ()) + m.state:
            n[key] = n.get(key, 0) + 1
    return n


def _layer_views(cfg: ModelConfig, params, stacks, kv: Tuple[str, ...]):
    """Each layer's (params, kind, state views): its rows of the ``kv``
    stacks (K/V, or a block table) and of its recurrent state's."""
    a = m = 0
    for i, p in enumerate(params["blocks"]):
        kind = cfg.mixer(i)
        mx, st = MIXERS[kind], {}
        if mx.attends:
            st.update((key, stacks[key][a]) for key in kv)
            a += 1
        if mx.state:
            st.update((key, stacks[key][m]) for key in mx.state)
            m += 1
        yield p, kind, st


def _attend_prompt(p, xn, cfg: ModelConfig, st, impl: str):
    """A whole prompt's attention; ``st`` takes its K/V [B,S,Hkvp,dh] (a
    W-row ring under a sliding window; under kv-quant int8 with
    ``k_scale``/``v_scale`` [B,S,Hkvp], after attending unquantized)."""
    y, (k, v) = attn_full(p, xn, cfg, impl=impl)
    new = {"k": k, "v": v}
    if cfg.kv_quant:
        new["k"], new["k_scale"] = _kv_quantize(k)
        new["v"], new["v_scale"] = _kv_quantize(v)
    if cfg.sliding_window:      # (the reference's placement needs W)
        new = {key: _ring(t, cfg.sliding_window) for key, t in new.items()}
    st.update(new)
    return y


def _stacked(t, n: int):
    """An empty [n, *t.shape] of ``t``'s dtype and device (a DTensor's
    layout one dim on) for the layers' entries, written as each is made:
    the cache is held once, where stacking a list of them at the end
    holds it twice (the reference's scan writes its stacked output in
    place)."""
    if not isinstance(t, DTensor):
        return t.new_empty((n,) + tuple(t.shape))
    local = t.to_local()
    return DTensor.from_local(
        local.new_empty((n,) + tuple(local.shape)), t.device_mesh,
        [Shard(p.dim + 1) if isinstance(p, Shard) else p
         for p in t.placements], run_check=False)


def _write_layer(buf, i: int, t) -> None:
    """buf[i] = t, on the local shards under a mesh (``_stacked`` gave
    ``buf`` the layout of ``t`` one dim on)."""
    if isinstance(t, DTensor):
        buf, t = buf.to_local(), t.to_local()
    buf[i].copy_(t)


def prefill_full(params, cfg: ModelConfig, inputs, *,
                 capacity: Optional[int] = None, impl: str = "kernel"):
    """Single-shot prefill. inputs: {"tokens": [B,S] int} (and a vision
    configuration's ``patch_embeds``, prepended). Returns (logits [B,Vp]
    fp32, cache): each entry of ``cache_stacks`` over its layers (K/V
    [La,B,S,Hkvp,dh], the W-row ring under a sliding window; a recurrent
    state after the prompt) and "pos" [B]. As in the reference, only a
    model that keeps no recurrent state grows its K/V to ``capacity``."""
    _check_family(cfg)
    x, _ = embed_inputs(params, cfg, inputs)
    B, S, _ = x.shape
    capacity = capacity or S
    attend = functools.partial(_attend_prompt, impl=impl)
    stacks = cache_stacks(cfg)
    cache, written = {}, {}
    for i, p in enumerate(params["blocks"]):
        st = {}
        x, _ = _layer(p, x, cfg, cfg.mixer(i), st, attend, impl)
        for key, t in st.items():
            if key not in cache:
                cache[key], written[key] = _stacked(t, stacks[key]), 0
            _write_layer(cache[key], written[key], t)
            written[key] += 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1])
    if capacity > S and set(stacks) <= set(_kv_keys(cfg)):
        for key in stacks:                      # grow to the capacity
            c = cache[key]
            pad = c.new_zeros(c.shape[:2] + (capacity - S,) + c.shape[3:])
            cache[key] = torch.cat([c, pad], dim=2)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache


def init_slot_state(cfg: ModelConfig, slots: int, *, device):
    """Zero recurrent state of ``slots`` slots over the layers that keep it
    (a jamba model's ``ssm_h`` [Lm, slots, di, ds] fp32 and ``conv`` [Lm,
    slots, K-1, di], beside its engine's block pool); {} for attention."""
    out, stacks = {}, cache_stacks(cfg)
    for i in range(cfg.num_layers):
        mx = MIXERS[cfg.mixer(i)]
        if not mx.state or mx.state[0] in out:
            continue
        n = stacks[mx.state[0]]
        out.update((key, t.reshape((n, slots) + t.shape[1:])) for key, t
                   in mx.zeros(cfg, n * slots, device=device).items())
    return out


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, device):
    """Empty dense cache {"k","v": [L,B,C,Hkvp,dh], "pos": [B] int32}
    (decoding starts at pos 0), or for RWKV the zero state {"s":
    [L,B,H,N,N] fp32, "tm_x", "cm_x": [L,B,D], "pos"} (no capacity): the
    reference's ``init_cache``. A sliding window makes C = W (the ring)
    whatever ``capacity``; kv-quant makes K/V int8 and adds the bf16
    ``k_scale``/``v_scale`` [L,B,C,Hkvp]; a hybrid cache adds the zero SSM
    state ``ssm_h`` [L,B,di,ds] fp32 and ``conv`` [L,B,K-1,di]
    (``init_slot_state``). A jamba model has no dense layout."""
    _check_family(cfg)
    if not _takes(cfg, "dense"):
        raise ValueError(f"{cfg.name}: a {cfg.block} model serves on the "
                         "paged layout only")
    cache = {}
    La = len(cfg.attn_layer_ids)
    if La:
        C = cfg.sliding_window or capacity
        shape = (La, batch, C, cfg.padded_kv_heads, cfg.dh)
        kv_dt = torch.int8 if cfg.kv_quant else cfg.tdtype
        for key in _kv_keys(cfg):
            scale = key.endswith("_scale")
            cache[key] = torch.zeros(shape[:-1] if scale else shape,
                                     dtype=torch.bfloat16 if scale else kv_dt,
                                     device=device)
    cache.update(init_slot_state(cfg, batch, device=device))
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    return {**cache, "pos": pos}


def abstract_cache(cfg: ModelConfig, batch: int, capacity: int):
    """``init_cache``'s tree on the meta device (no storage)."""
    return init_cache(cfg, batch, capacity, device="meta")


def decode_step(params, cfg: ModelConfig, cache, tokens,
                impl: str = "kernel"):
    """Batched decode step on the dense layout. tokens: [B]. Returns
    (logits [B,Vp] fp32, cache) with ``pos + 1`` for every slot, as the
    reference (inactive slots advance too; their writes clamp at C-1, or
    wrap in a ring, and nothing live reads them; an RWKV or SSM step
    advances their state, which ``insert`` overwrites whole). K/V and the
    state are updated in place."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])
    pos = cache["pos"]
    attend = (lambda p, xn, cfg, st: attn_decode(
        p, xn, cfg, st["k"], st["v"], pos, impl=impl, scales=st)[0])
    for p, kind, st in _layer_views(cfg, params, cache, _kv_keys(cfg)):
        x, _ = _layer(p, x, cfg, kind, st, attend, impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, 0]), {**cache, "pos": pos + 1}


def prefill_chunked(params, cfg: ModelConfig, inputs, chunk_size: int, *,
                    capacity: Optional[int] = None, impl: str = "kernel",
                    cache=None, start: int = 0):
    """Chunked (Sarathi-style) prefill on the dense layout: the prompt in
    ``chunk_size`` pieces, the cache carried between chunks. ``cache`` /
    ``start`` resume from a cached prefix (tokens[:, :start] already in the
    cache); that cache is written in place. Returns (logits [B,Vp] fp32 at
    the last input position, cache with ``pos`` = the input length)."""
    _check_takes(cfg, "chunked", "chunked prefill")
    x, _ = embed_inputs(params, cfg, inputs)
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
        attend = (lambda p, xn, cfg, st: attn_chunk(
            p, xn, cfg, st["k"], st["v"], lo, impl=impl)[0])
        for p, kind, st in _layer_views(cfg, params, cache, ("k", "v")):
            out, _ = _layer(p, out, cfg, kind, st, attend, impl)
    out = L.rms_norm(out, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, out[:, -1]), {
        "k": cache["k"], "v": cache["v"],
        "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}


# ---------------------------------------------------------------------------
# Paged KV cache


def supports_paged(cfg: ModelConfig) -> bool:
    """Paged serving: every layer's mixer takes the paged layout, with a
    bf16 cache and no sliding window (a ring has no KV growth to page)."""
    return (_takes(cfg, "paged") and not cfg.kv_quant
            and not cfg.sliding_window)


def supports_chunked(cfg: ModelConfig) -> bool:
    """A prompt may run in chunks, resumed from a cached prefix: the
    attention family with a bf16 cache."""
    return _takes(cfg, "chunked") and not cfg.kv_quant


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


def attn_chunk_paged(p, x, cfg: ModelConfig, pool_k, pool_v, tbl,
                     kv_offset: int, impl: str = "kernel"):
    """``attn_chunk`` for one request's blocks, ``tbl`` [nb] int32: x
    [1,Sq,D] is whole blocks; ``_attend_chunk`` over the live blocks
    gathered (the reference's ``"pallas"`` branch) or the whole table
    (its ``"xla"`` branch)."""
    _check_impl(impl)
    Sq = x.shape[1]
    off = int(kv_offset)
    Bs = pool_k.shape[1]
    q, k, v = _qkv(p, x, cfg, off + torch.arange(Sq, device=x.device)[None])
    wids = tbl[off // Bs:(off + Sq) // Bs].long()
    for pool, t in ((pool_k, k), (pool_v, v)):
        pool.index_copy_(0, wids, t[0].reshape((-1,) + pool.shape[1:])
                         .to(pool.dtype))

    def rows(n):
        ids = tbl[:n // Bs] if n else tbl
        return (pool_k[ids.long()].reshape((1, -1) + pool_k.shape[2:]),
                pool_v[ids.long()].reshape((1, -1) + pool_v.shape[2:]))

    return _attend_chunk(p, x, cfg, q, off, rows, impl), (pool_k, pool_v)


def decode_step_paged(params, cfg: ModelConfig, pool, tables, pos, tokens,
                      impl: str = "kernel", *, graphs=None):
    """Batched decode step on the paged layout. tables: [L,B,nb] int32 (a
    jamba model's over its attention layers); pos, tokens: [B]. Returns
    (logits [B,Vp] fp32, pool, pos+1); the pool (with a jamba model's
    per-slot SSM state) is updated in place.

    ``graphs``: an engine's ``serving.graphs.DecodeGraphs``. With it, on a
    CUDA device under ``impl="kernel"``, the step is one replay of the
    CUDA graph captured from this function's body for the inputs' shapes
    (on the first step at those shapes); the logits and positions
    returned are the graph's own tensors, overwritten by its next replay.
    Anywhere else it is ignored."""
    if graphs is not None and impl == "kernel" and tokens.is_cuda:
        def body(tables, pos, tokens):
            logits, _, pos1 = _decode_step_paged_eager(
                params, cfg, pool, tables, pos, tokens, impl)
            return logits, pos1
        logits, pos1 = graphs.run(
            body, (tables, pos, tokens),
            pinned=tuple(pool.values()) + (params["embed"],),
            counters=(decode_attention_paged,))
        return logits, pool, pos1
    return _decode_step_paged_eager(params, cfg, pool, tables, pos, tokens,
                                    impl)


def _decode_step_paged_eager(params, cfg: ModelConfig, pool, tables, pos,
                             tokens, impl: str):
    """``decode_step_paged``'s body, every op launched as it is reached: a
    jamba model's Mamba-1 layers step their slots' state in place."""
    _check_takes(cfg, "paged", "the paged layout")
    x = embed_tokens(params, cfg, tokens[:, None])
    attend = (lambda p, xn, cfg, st: attn_decode_paged(
        p, xn, cfg, pool["k"], pool["v"], st["table"], pos, impl=impl)[0])
    for p, kind, st in _layer_views(cfg, params, {**pool, "table": tables},
                                    ("table",)):
        x, _ = _layer(p, x, cfg, kind, st, attend, impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, 0]), pool, pos + 1


def prefill_chunked_paged(params, cfg: ModelConfig, inputs, chunk_size: int,
                          pool, tables, *, start: int = 0,
                          impl: str = "kernel"):
    """Chunked prefill that appends straight into the request's blocks (no
    dense B=1 cache). B=1; tables: [L, nb] covering the prompt;
    ``chunk_size % block_size == 0`` so every chunk lands on block
    boundaries. ``start`` resumes after a prefix-cache hit (those blocks
    already hold the prefix KV). Each layer of each chunk is one
    ``attn_chunk_paged``. Returns (logits [1,Vp] fp32, pool)."""
    _check_takes(cfg, "chunked", "chunked prefill")
    x, _ = embed_inputs(params, cfg, inputs)
    B, S, _ = x.shape
    Bs = pool["k"].shape[1]
    W = tables.shape[1] * Bs
    if B != 1:
        raise ValueError("paged prefill is per request (B=1)")
    if chunk_size % Bs:
        raise ValueError(f"chunk {chunk_size} is not block-aligned ({Bs})")
    if (S - start) % chunk_size or start % chunk_size:
        raise ValueError(f"prompt {S} / start {start} not in whole chunks "
                         f"of {chunk_size}")
    if S > W:
        raise ValueError(f"prompt {S} exceeds the table window {W}")
    out = x[:, :0]
    for lo in range(start, S, chunk_size):
        out = x[:, lo:lo + chunk_size]
        attend = (lambda p, xn, cfg, st: attn_chunk_paged(
            p, xn, cfg, pool["k"], pool["v"], st["table"], lo, impl=impl)[0])
        for p, kind, st in _layer_views(cfg, params, {"table": tables},
                                        ("table",)):
            out, _ = _layer(p, out, cfg, kind, st, attend, impl)
    out = L.rms_norm(out, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, out[:, -1]), pool


def verify_chunk(params, cfg: ModelConfig, cache, tokens, start: int,
                 impl: str = "kernel"):
    """Score ``tokens`` [B,k] at positions [start, start+k) against the
    dense cache: the speculative-decoding verify pass. Writes the tokens'
    K/V into the cache in place (a rejected suffix is overwritten by the
    next call, and causally masked meanwhile) and returns (logits
    [B,k,Vp] fp32, the cache with ``pos`` = start + k). Each layer is one
    ``attn_chunk``: on the card the flash kernel with k query rows at
    ``q_offset=start``. The attention family with a bf16 cache only, as
    the reference asserts."""
    _check_takes(cfg, "chunked", "the verify pass")
    x, _ = embed_inputs(params, cfg, {"tokens": tokens})
    B, k, D = x.shape
    attend = (lambda p, xn, cfg, st: attn_chunk(
        p, xn, cfg, st["k"], st["v"], start, impl=impl)[0])
    for p, kind, st in _layer_views(cfg, params, cache, ("k", "v")):
        x, _ = _layer(p, x, cfg, kind, st, attend, impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x.reshape(B * k, D)).reshape(B, k, -1)
    return logits, {**cache, "pos": torch.full_like(cache["pos"],
                                                    start + k)}


# ---------------------------------------------------------------------------
# Training: the full-sequence causal LM loss


def _zero_aux(device):
    return {k: torch.zeros((), dtype=f32, device=device)
            for k in ("moe_aux_loss", "moe_z_loss", "moe_dropped")}


def _pad_aux(aux, device):
    out = _zero_aux(device)
    out.update(aux)
    return out


def _layer_train(p, x, cfg: ModelConfig, kind: str):
    """One layer of the training forward: (x, MoE metrics padded with
    zeros). A recurrence starts from the zero state."""
    x, aux = _layer(p, x, cfg, kind, {}, lambda p, xn, cfg, st: attn_full(
        p, xn, cfg, impl="xla")[0], "plain")
    return x, _pad_aux(aux, x.device)


def forward_hidden(params, cfg: ModelConfig, inputs):
    """Training-mode forward to the final hidden states. Returns (x
    [B,S,D], the frontend's loss mask or None, the MoE metrics averaged
    over the layers). With ``cfg.remat`` each layer is recomputed in the
    backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its scan body). A jamba model serves only."""
    _check_family(cfg)
    if not _takes(cfg, "train"):
        raise NotImplementedError(f"{cfg.name}: training is not ported "
                                  f"for {cfg.block} blocks")
    x, mask = embed_inputs(params, cfg, inputs)
    aux = _zero_aux(x.device)
    for i, p in enumerate(params["blocks"]):
        if cfg.remat:
            x, a = checkpoint(_layer_train, p, x, cfg, cfg.mixer(i),
                              use_reentrant=False)
        else:
            x, a = _layer_train(p, x, cfg, cfg.mixer(i))
        aux = {k: aux[k] + a[k] for k in aux}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, mask, {k: v / cfg.num_layers for k, v in aux.items()}


class _MatmulF32(torch.autograd.Function):
    """x [T,D] @ w [D,V] in bf16 on the card with an fp32 product (the
    reference's ``preferred_element_type=f32``); the backward's products
    take the fp32 cotangent rounded to w's dtype, as mixed-precision
    training does, and accumulate in fp32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=f32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        return g @ w.T, torch.mm(x.T, g, out_dtype=f32).to(w.dtype)


def _chunk_loss(xc, head, lc, mc, cfg: Optional[ModelConfig]):
    """Summed CE of one chunk: fp32 logits [B,Sc,V] (padded vocabulary
    masked), their logsumexp minus the label's logit, times the mask."""
    B, Sc, D = xc.shape
    if xc.is_cuda and xc.dtype != f32:
        logits = _MatmulF32.apply(xc.reshape(B * Sc, D), head)
    else:
        logits = xc.reshape(B * Sc, D).float() @ head.float()
    logits = constrain(logits.reshape(B, Sc, -1), "dp", None, "vocab")
    if cfg is not None:
        logits = _mask_padded_vocab(logits, cfg)
    if _sharded(logits):
        # vocab-sharded: the max and the sums reduce over the vocab shards
        # (all-reduces), and the label's logit is a masked sum -- DTensor
        # would gather the logits for logsumexp and cannot reduce a
        # gather's masked partial
        # (each reduction replicated at once: left partial, DTensor may
        # reduce-scatter it over the sequence, a layout its backward
        # cannot carry through the [B*Sc, D] product)
        m = constrain(logits.detach().amax(dim=-1, keepdim=True),
                      "dp", None, None)
        se = constrain(torch.exp(logits - m).sum(dim=-1, keepdim=True),
                       "dp", None, None)
        lse = (m + torch.log(se))[..., 0]
        hit = torch.arange(logits.shape[-1], device=lc.device) == \
            lc.long()[..., None]
        ll = constrain(torch.where(hit, logits, torch.zeros_like(logits))
                       .sum(dim=-1), "dp", None)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return ((lse - ll) * mc).sum()


def chunked_cross_entropy(x, lm_head, labels, mask, chunk: int,
                          cfg: Optional[ModelConfig] = None):
    """Mean CE over the masked positions, chunk by chunk along S so the
    [B,S,V] logits are never whole: each chunk's loss is recomputed in the
    backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``). A ragged tail is padded with masked positions."""
    S = x.shape[1]
    Sc = min(chunk, S)
    pad = (-S) % Sc
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    maskf = mask.to(f32)
    total = torch.zeros((), dtype=f32, device=x.device)
    for lo in range(0, S + pad, Sc):
        total = total + checkpoint(
            _chunk_loss, x[:, lo:lo + Sc], lm_head, labels[:, lo:lo + Sc],
            maskf[:, lo:lo + Sc], cfg, use_reentrant=False)
    return total / maskf.sum().clamp(min=1.0)


def train_loss(params, cfg: ModelConfig, batch):
    """batch: {"tokens": [B,S], "labels": [B,S], optional "loss_mask"
    [B,S] bool and, for a vision configuration, "patch_embeds" (then
    tokens are [B,S-P] and the P patch positions are never scored)}.
    Returns (loss, metrics {"ce", "moe_aux_loss", "moe_z_loss",
    "moe_dropped"}); an MoE configuration adds 0.01 x the aux loss and
    1e-3 x the z loss to the CE. No hand-written kernel runs."""
    x, vis_mask, aux = forward_hidden(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.bool, device=x.device)
    if vis_mask is not None:
        mask = mask & vis_mask
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    ce = chunked_cross_entropy(x, head, labels, mask, cfg.logits_chunk,
                               cfg=cfg)
    loss = ce
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["moe_aux_loss"] + 1e-3 * aux["moe_z_loss"]
    return loss, {"ce": ce, **aux}
