"""Public wrapper of the flash-attention kernel.

On a CUDA tensor ``flash_attention`` launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version (``ref.flash_attention_ref``). There is no fallback from
one to the other. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# most query heads per KV head the kernel packs into its 64-row tiles
MAX_GROUP = 16
# the head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                           ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = _ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,H,dh], k/v [B,Skv,Hkv,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: int = 0):
    """Causal (or full) GQA attention. q: [B,Sq,H,dh]; k, v:
    [B,Skv,Hkv,dh] un-expanded (the kernel maps q head h to KV head
    h // (H/Hkv), and packs the H/Hkv heads of a group into its rows, so
    it takes H/Hkv up to MAX_GROUP and dh in HEAD_DIMS). ``window`` > 0
    bands causal attention to the ``window`` keys up to each row's
    position (0: no window; the kernel is launched unbanded when no row's
    band starts past key 0). Returns [B,Sq,H,dh] in q.dtype."""
    _check_inputs(q, k, v)
    if window < 0 or (window and not causal):
        raise ValueError(f"window must be 0 or > 0 with causal=True, got "
                         f"window={window}, causal={causal}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous bfloat16, got {t.dtype}")
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"flash_attention kernel: {H // Hkv} query heads per "
                         f"KV head, more than {MAX_GROUP}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window >= Sq + q_offset:
        # every row's band reaches key 0: the unbanded build computes the
        # same output bit for bit, without the per-row lower bound
        window = 0
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Skv, H, Hkv, dh, int(q_offset), int(bool(causal)), int(window),
            1.0 / math.sqrt(dh), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
