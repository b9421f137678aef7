"""Public wrapper of the paged decode kernel.

On CUDA tensors ``decode_attention_paged`` launches the hand-written
kernels of ``csrc/paged_decode.cu`` (split-KV partials, then the
cross-split merge) or raises; on CPU tensors it runs the plain version:
the same partials from ``ref.paged_decode_partials_ref`` and the same
merge, ``_merge_splits``, in PyTorch (the JAX wrapper merges in jnp
outside its Pallas kernel). There is no fallback from the kernel to the
plain path. ``decode_attention_paged.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import paged_decode_partials_ref

SPLIT_TOKENS = 128      # tokens one CTA walks (the kernel's TMAX)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                           ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("paged_decode")
    lib.paged_decode_fwd.argtypes = _ARGTYPES
    lib.paged_decode_fwd.restype = ctypes.c_int
    return lib


def pages_per_split(block_size: int) -> int:
    """Table entries per split: as many blocks as fit in SPLIT_TOKENS."""
    if block_size > SPLIT_TOKENS:
        raise ValueError(f"block_size {block_size} > {SPLIT_TOKENS}")
    return SPLIT_TOKENS // block_size


def _merge_splits(o, m, l):
    """Cross-split online-softmax reduction (splits on dim 2)."""
    m_all = m.amax(dim=2, keepdim=True)                       # [B,Hkv,1,G]
    alpha = torch.exp(m - m_all)                              # [B,Hkv,S,G]
    l_all = (l * alpha).sum(dim=2)                            # [B,Hkv,G]
    o_all = (o * alpha[..., None]).sum(dim=2)                 # [B,Hkv,G,dh]
    return o_all / l_all.clamp_min(1e-30)[..., None]


def _kernel(qg, pool_k, pool_v, tables, lengths):
    """Launch the split kernel and the merge kernel; returns [B,Hkv,G,dh]
    in bf16."""
    B, Hkv, G, dh = qg.shape
    Bs = pool_k.shape[1]
    nb = tables.shape[1]
    for name, t, dt in (("q", qg, torch.bfloat16),
                        ("pool_k", pool_k, torch.bfloat16),
                        ("pool_v", pool_v, torch.bfloat16),
                        ("tables", tables, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if t.device != qg.device:
            raise ValueError(f"{name} on {t.device}, q on {qg.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"paged decode kernel: {name} must be "
                             f"contiguous {dt}, got {t.dtype}")
    if dh != 128 or G > 16:
        raise ValueError(f"paged decode kernel: needs dh == 128 and "
                         f"G <= 16, got dh={dh}, G={G}")
    if (pool_v.shape != pool_k.shape or pool_k.dim() != 4
            or tuple(pool_k.shape[2:]) != (Hkv, dh)
            or tables.dim() != 2 or tables.shape[0] != B
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"paged decode kernel: q {tuple(qg.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}, "
                         f"tables {tuple(tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit together")
    pps = pages_per_split(Bs)
    S = -(-nb // pps)
    dev = qg.device
    o = torch.empty((B, Hkv, S, G, dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv, S, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    out = torch.empty_like(qg)
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
        pages_per_split=pages_per_split(pool_k.shape[1]))
    return _merge_splits(o, m, l).reshape(B, H, dh).to(q.dtype)


decode_attention_paged.launches = 0
