"""Public wrapper of the WKV kernel.

On CUDA tensors ``wkv`` launches the hand-written kernel of
``csrc/wkv.cu`` or raises; on CPU tensors it runs the plain chunked form,
``ref.wkv_chunked``. There is no fallback from one to the other.
``wkv.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6.ref import wkv_chunked

HEAD_SIZES = (32, 64)       # the kernel's template instances
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("wkv")
    lib.wkv_fwd.argtypes = _ARGTYPES
    lib.wkv_fwd.restype = ctypes.c_int
    return lib


def _check_shapes(r, k, v, logw, u, state0, out_state):
    if r.dim() != 4:
        raise ValueError(f"wkv: r must be [B,S,H,N], got {tuple(r.shape)}")
    B, S, H, N = r.shape
    want = {"k": (k, r.shape), "v": (v, r.shape), "logw": (logw, r.shape),
            "u": (u, (H, N)), "state0": (state0, (B, H, N, N))}
    if out_state is not None:
        want["out_state"] = (out_state, (B, H, N, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv: {name} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)} for r {tuple(r.shape)}")
        if t.device != r.device:
            raise ValueError(f"wkv: {name} on {t.device}, r on {r.device}")


def wkv(r, k, v, logw, u, state0, *, out_state=None):
    """The RWKV-6 WKV recurrence. r, k, v, logw: [B,S,H,N]; u: [H,N];
    state0: [B,H,N,N] fp32. Returns (y [B,S,H,N] fp32, final state
    [B,H,N,N] fp32). ``out_state`` receives the final state (it may be
    ``state0`` itself: the decode step updates its cache in place) and is
    what is returned."""
    _check_shapes(r, k, v, logw, u, state0, out_state)
    if r.device.type == "cpu":
        y, s = wkv_chunked(r, k, v, logw, u, state0)
        if out_state is None:
            return y, s
        out_state.copy_(s)
        return y, out_state
    if r.device.type != "cuda":
        raise ValueError(f"wkv: unsupported device {r.device}")
    B, S, H, N = r.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv kernel: head size {N} not in {HEAD_SIZES}")
    in_dt = r.dtype
    if in_dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"wkv kernel: r/k/v must be bfloat16 or float32, "
                         f"got {in_dt}")
    s_out = torch.empty_like(state0) if out_state is None else out_state
    named = dict(r=r, k=k, v=v, logw=logw, u=u, state0=state0,
                 out_state=s_out)
    for name, t in named.items():
        dt = in_dt if name in ("r", "k", "v") else torch.float32
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"wkv kernel: {name} must be contiguous {dt}, "
                             f"got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"wkv kernel: {name} must start on 16 bytes "
                             "(the kernel reads it in 16-byte pieces)")
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _lib().wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, S, H, N, int(in_dt == torch.bfloat16), stream)
    _build.check(err, "wkv_fwd")
    wkv.launches += 1
    return y, s_out


wkv.launches = 0
