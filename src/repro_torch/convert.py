"""Parameters of the JAX package, carried into the port.

``from_reference`` takes the reference's parameter pytree as numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)``), with its stacked ``[L, ...]``
layer axis, and returns the port's layout (``params["blocks"]`` a list of
per-layer dicts) as tensors on ``device``. Tests use it so that both
packages compute with the same weights; nothing here imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _tensor(a, device, dtype: Optional[torch.dtype]):
    # numpy has no bfloat16: ml_dtypes arrays go through float32
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return t.to(dtype) if dtype is not None else t


def from_reference(params: Dict[str, Any], *, device,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Reference pytree (numpy leaves, stacked layer axis) -> port params.
    ``dtype`` casts every leaf (default: keep each leaf's own type)."""
    device = torch.device(device)
    blocks = params["blocks"]
    n_layers = len(next(iter(blocks.values())))
    out: Dict[str, Any] = {
        k: _tensor(v, device, dtype) for k, v in params.items()
        if k != "blocks"}
    out["blocks"] = [
        {k: _tensor(np.asarray(v)[i], device, dtype)
         for k, v in blocks.items()}
        for i in range(n_layers)]
    return out
