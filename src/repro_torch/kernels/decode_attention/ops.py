"""Public wrappers of the two split-KV decode kernels.

- ``decode_attention`` (dense per-slot cache): on CUDA tensors it launches
  the hand-written kernels of ``csrc/decode_attention.cu`` (split-KV
  partials over ``split_tokens`` rows each, then the shared cross-split
  merge) or raises; on CPU tensors it runs its plain version,
  ``ref.decode_attention_ref``.
- ``decode_attention_paged`` (block pool): on CUDA tensors it launches
  the kernels of ``csrc/paged_decode.cu`` or raises; on CPU tensors it
  runs the plain version: the same partials from
  ``ref.paged_decode_partials_ref`` and the same merge, ``_merge_splits``,
  in PyTorch (the JAX wrapper merges in jnp outside its Pallas kernel).

There is no fallback from a kernel to its plain path. Each wrapper's
``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_partials_ref)

SPLIT_TOKENS = 128      # most rows a split kernel stages (csrc TMAX)
MIN_SPLIT_TOKENS = 32   # fewest tokens in a split
MAX_SPLIT_TOKENS = 64   # most tokens in a split
TARGET_CTAS = 264       # two CTAs on each of the H100's 132 SMs
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                           ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("paged_decode")
    lib.paged_decode_fwd.argtypes = _ARGTYPES
    lib.paged_decode_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _dense_lib():
    lib = _build.load("decode_attention")
    lib.dense_decode_fwd.argtypes = _DENSE_ARGTYPES
    lib.dense_decode_fwd.restype = ctypes.c_int
    return lib


def pages_per_split(B: int, Hkv: int, nb: int, block_size: int) -> int:
    """Table entries per split of the paged kernel, from the shape: whole
    pages of at least MIN_SPLIT_TOKENS tokens (one page where a page is
    larger, up to SPLIT_TOKENS) and at most MAX_SPLIT_TOKENS, the most
    that still gives ``B * Hkv * n_splits >= TARGET_CTAS`` — fewer,
    longer splits cut the partials' traffic where the grid is full anyway
    — or the fewest when the table is too narrow to reach that."""
    if block_size > SPLIT_TOKENS:
        raise ValueError(f"block_size {block_size} > {SPLIT_TOKENS}")
    lo = -(-MIN_SPLIT_TOKENS // block_size)
    for pps in range(max(lo, MAX_SPLIT_TOKENS // block_size), lo, -1):
        if B * Hkv * -(-nb // pps) >= TARGET_CTAS:
            return pps
    return lo


def split_tokens(B: int, Hkv: int, Smax: int) -> int:
    """Cache rows per split of the dense kernel, from the shape: a
    multiple of 16 from MIN_SPLIT_TOKENS to MAX_SPLIT_TOKENS, the longest
    that still gives ``B * Hkv * n_splits >= TARGET_CTAS``, or the
    shortest when the cache is too short to reach that. The last split
    stops at Smax."""
    for T in range(MAX_SPLIT_TOKENS, MIN_SPLIT_TOKENS, -16):
        if B * Hkv * -(-Smax // T) >= TARGET_CTAS:
            return T
    return MIN_SPLIT_TOKENS


def _merge_splits(o, m, l):
    """Cross-split online-softmax reduction (splits on dim 2)."""
    m_all = m.amax(dim=2, keepdim=True)                       # [B,Hkv,1,G]
    alpha = torch.exp(m - m_all)                              # [B,Hkv,S,G]
    l_all = (l * alpha).sum(dim=2)                            # [B,Hkv,G]
    o_all = (o * alpha[..., None]).sum(dim=2)                 # [B,Hkv,G,dh]
    return o_all / l_all.clamp_min(1e-30)[..., None]


def _check_operands(what, qg, **tensors):
    """Device, dtype (bf16, int32 for ``tables``/``lengths``), contiguity
    and head geometry: what both decode kernels take."""
    for name, t in dict(q=qg, **tensors).items():
        dt = torch.int32 if name in ("tables", "lengths") else torch.bfloat16
        if t.device != qg.device:
            raise ValueError(f"{name} on {t.device}, q on {qg.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt}, got "
                             f"{t.dtype}")
    G, dh = qg.shape[2:]
    if dh != 128 or G > 16:
        raise ValueError(f"{what}: needs dh == 128 and G <= 16, got dh={dh}, "
                         f"G={G}")


def _partials(qg, n_splits):
    """Scratch (o, m, l) fp32 partials and the bf16 output."""
    B, Hkv, G, dh = qg.shape
    o = torch.empty((B, Hkv, n_splits, G, dh), dtype=torch.float32,
                    device=qg.device)
    m = torch.empty((B, Hkv, n_splits, G), dtype=torch.float32,
                    device=qg.device)
    return o, m, torch.empty_like(m), torch.empty_like(qg)


def _kernel(qg, pool_k, pool_v, tables, lengths):
    """Launch the split kernel and the merge kernel; returns [B,Hkv,G,dh]
    in bf16."""
    B, Hkv, G, dh = qg.shape
    Bs = pool_k.shape[1]
    nb = tables.shape[1]
    _check_operands("paged decode kernel", qg, pool_k=pool_k, pool_v=pool_v,
                    tables=tables, lengths=lengths)
    if (pool_v.shape != pool_k.shape or pool_k.dim() != 4
            or tuple(pool_k.shape[2:]) != (Hkv, dh)
            or tables.dim() != 2 or tables.shape[0] != B
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"paged decode kernel: q {tuple(qg.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}, "
                         f"tables {tuple(tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit together")
    pps = pages_per_split(B, Hkv, nb, Bs)
    S = -(-nb // pps)
    dev = qg.device
    o, m, l, out = _partials(qg, S)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().paged_decode_fwd(
            qg.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), out.data_ptr(), B, Hkv, G, Bs, nb,
            pps, S, 1.0 / math.sqrt(dh), stream)
    _build.check(err, "paged_decode_fwd")
    decode_attention_paged.launches += 1
    return out


def decode_attention_paged(q, pool_k, pool_v, tables, lengths):
    """Paged-layout decode attention. q: [B,H,dh]; pools: [N,Bs,Hkv,dh];
    tables: [B,nb] int32 block ids (the window, in sequence order);
    lengths: [B] int32 valid positions, each <= nb*Bs. Returns [B,H,dh]
    in q.dtype."""
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, pool_k, pool_v, tables,
                                            lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device "
                         f"{q.device}")
    B, H, dh = q.shape
    if H % pool_k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of Hkv={pool_k.shape[2]}")
    qg = q.reshape(B, pool_k.shape[2], -1, dh).contiguous()
    return _kernel(qg, pool_k, pool_v, tables, lengths).reshape(B, H, dh)


def decode_attention_paged_plain(q, pool_k, pool_v, tables, lengths):
    """The wrapper's plain version on any device: the kernel's plain
    partials and the same merge (``impl="plain"``, the CPU path and the
    card checks)."""
    B, H, dh = q.shape
    Hkv = pool_k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    o, m, l = paged_decode_partials_ref(
        q.reshape(B, Hkv, H // Hkv, dh), pool_k, pool_v, tables, lengths,
        pages_per_split=pages_per_split(B, Hkv, tables.shape[1],
                                        pool_k.shape[1]))
    return _merge_splits(o, m, l).reshape(B, H, dh).to(q.dtype)


decode_attention_paged.launches = 0


def _dense_kernel(qg, k_cache, v_cache, lengths):
    """Launch the dense split kernel and the merge kernel; returns
    [B,Hkv,G,dh] in bf16."""
    B, Hkv, G, dh = qg.shape
    _check_operands("dense decode kernel", qg, k_cache=k_cache,
                    v_cache=v_cache, lengths=lengths)
    if (v_cache.shape != k_cache.shape or k_cache.dim() != 4
            or k_cache.shape[0] != B
            or tuple(k_cache.shape[2:]) != (Hkv, dh)
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"dense decode kernel: q {tuple(qg.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)} do not fit "
                         "together")
    Smax = k_cache.shape[1]
    T = split_tokens(B, Hkv, Smax)
    S = -(-Smax // T)
    dev = qg.device
    o, m, l, out = _partials(qg, S)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _dense_lib().dense_decode_fwd(
            qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            out.data_ptr(), B, Smax, Hkv, G, T, S, 1.0 / math.sqrt(dh),
            stream)
    _build.check(err, "dense_decode_fwd")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """Dense-cache decode attention. q: [B,H,dh]; caches:
    [B,Smax,Hkv,dh]; lengths: [B] int32 live rows per sequence (clamped to
    Smax). Returns [B,H,dh] in q.dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, dh = q.shape
    if H % k_cache.shape[2]:
        raise ValueError(f"H={H} is not a multiple of Hkv="
                         f"{k_cache.shape[2]}")
    qg = q.reshape(B, k_cache.shape[2], -1, dh).contiguous()
    return _dense_kernel(qg, k_cache, v_cache, lengths).reshape(B, H, dh)


decode_attention.launches = 0
