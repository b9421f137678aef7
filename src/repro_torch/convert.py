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


def _layer(tree: Dict[str, Any], i: int, device, dtype):
    """Layer i of a stacked block dict; nested dicts (an MoE layer's
    ``moe``: router, wg, wu, wd, ...) keep their nesting."""
    return {k: (_layer(v, i, device, dtype) if isinstance(v, dict)
                else _tensor(np.asarray(v)[i], device, dtype))
            for k, v in tree.items()}


def _num_layers(tree: Dict[str, Any]) -> int:
    leaf = next(iter(tree.values()))
    return _num_layers(leaf) if isinstance(leaf, dict) else len(leaf)


def from_reference(params: Dict[str, Any], *, device,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Reference pytree (numpy leaves, stacked layer axis) -> port params.
    ``dtype`` casts every leaf (default: keep each leaf's own type, e.g.
    an MoE router's fp32 in a bf16 config)."""
    device = torch.device(device)
    blocks = params["blocks"]
    out: Dict[str, Any] = {
        k: _tensor(v, device, dtype) for k, v in params.items()
        if k != "blocks"}
    out["blocks"] = [_layer(blocks, i, device, dtype)
                     for i in range(_num_layers(blocks))]
    return out
