"""What every architecture's plain reference shares: its precision.

Each architecture's module (``archs/<arch>.py``) has a ``Reference``, the
served model's forward pass in fp32 PyTorch that imports nothing of the
program. Its fp32 matrix products are held to fp32 (``full_fp32``: TF32
off while it runs). The control puts float8 e4m3 in place of fp32
(``fp8_quant``, passed as the reference's ``quant``: a function applied
to both operands of every projection).
"""
from __future__ import annotations

import contextlib

import torch

f32 = torch.float32


@contextlib.contextmanager
def full_fp32():
    """TF32 off for the products inside (and restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), back in fp32: the control's lower precision."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(f32) * scale


def fp8_quant(x: torch.Tensor, w: torch.Tensor):
    """Both operands of ``x @ w`` in fp8: x by row, w by output column."""
    return fp8_e4m3(x, -1), fp8_e4m3(w, 0)
