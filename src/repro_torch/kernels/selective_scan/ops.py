"""Public wrapper of the selective-scan kernel.

On CUDA tensors ``selective_scan`` launches the hand-written kernel of
``csrc/selective_scan.cu`` or raises; on CPU tensors it runs the plain
chunked scan, ``models.ssm._scan``. There is no fallback from one to the
other. ``selective_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

STATE_SIZES = (16,)         # the kernel's template instances
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("selective_scan")
    lib.selective_scan_fwd.argtypes = _ARGTYPES
    lib.selective_scan_fwd.restype = ctypes.c_int
    return lib


def _check_shapes(xf, B_ssm, C_ssm, delta, A, h):
    if xf.dim() != 3 or xf.shape[1] < 1:
        raise ValueError(f"selective_scan: xf must be [B,S,di] with S >= 1, "
                         f"got {tuple(xf.shape)}")
    B, S, di = xf.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"selective_scan: A is {tuple(A.shape)}, expected "
                         f"[{di}, ds] for xf {tuple(xf.shape)}")
    ds = A.shape[1]
    if tuple(delta.shape) not in ((B, S, di), (B, S)):
        raise ValueError(f"selective_scan: delta is {tuple(delta.shape)}, "
                         f"expected {(B, S, di)} or {(B, S)}")
    want = {"B_ssm": (B_ssm, (B, S, ds)), "C_ssm": (C_ssm, (B, S, ds)),
            "h": (h, (B, di, ds))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)}, "
                             f"expected {shape} for xf {tuple(xf.shape)}")
    for name, t in dict(B_ssm=B_ssm, C_ssm=C_ssm, delta=delta, A=A,
                        h=h).items():
        if t.device != xf.device:
            raise ValueError(f"selective_scan: {name} on {t.device}, xf on "
                             f"{xf.device}")


def selective_scan(xf, B_ssm, C_ssm, delta, A, h):
    """The SSM recurrence over a prompt, ``_scan``'s contract: xf [B,S,di]
    fp32, B/C [B,S,ds] fp32, delta [B,S,di] (one per channel) or [B,S]
    (one channel shared) fp32, A [di,ds] fp32, h [B,di,ds] fp32 (the state
    before the prompt). Returns (y = C_t h_t [B,S,di] fp32, the last h
    [B,di,ds] fp32)."""
    _check_shapes(xf, B_ssm, C_ssm, delta, A, h)
    if xf.device.type == "cpu":
        from repro_torch.models.ssm import _scan    # ssm imports this module
        return _scan(xf, B_ssm, C_ssm, delta, A, h)
    if xf.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {xf.device}")
    B, S, di = xf.shape
    ds = A.shape[1]
    if ds not in STATE_SIZES:
        raise ValueError(f"selective_scan kernel: state size {ds} not in "
                         f"{STATE_SIZES}")
    if di % 4:
        raise ValueError(f"selective_scan kernel: di = {di} is no multiple "
                         "of 4 (it reads rows in 16-byte pieces)")
    named = dict(xf=xf, B_ssm=B_ssm, C_ssm=C_ssm, delta=delta, A=A, h=h)
    for name, t in named.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"selective_scan kernel: {name} must be "
                             f"contiguous float32, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' strided'}")
        if t.data_ptr() % 16:
            raise ValueError(f"selective_scan kernel: {name} must start on "
                             "16 bytes (the kernel reads it in 16-byte "
                             "pieces)")
    y = torch.empty((B, S, di), dtype=torch.float32, device=xf.device)
    h_out = torch.empty_like(h)
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    with torch.cuda.device(xf.device):
        err = _lib().selective_scan_fwd(
            xf.data_ptr(), delta.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
            C_ssm.data_ptr(), h.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            B, S, di, ds, int(delta.dim() == 2), stream)
    _build.check(err, "selective_scan_fwd")
    selective_scan.launches += 1
    return y, h_out


selective_scan.launches = 0
