"""Sharded checkpoint save/restore in the reference's on-disk format
(``repro.checkpoint.checkpoint``): one ``.npy`` per leaf + a JSON manifest.

Per-leaf files mean restore parallelizes across hosts and a partial write
never corrupts earlier steps (write to a tmp dir, atomic rename). Leaves
are stored in the reference's pytree order under its key paths
(``repro_torch.tree``), so either package restores what the other saved.
numpy has no bfloat16: a bf16 leaf is stored as its ``uint16`` bits with
``"dtype": "bfloat16"`` in the manifest, and read back as those bits
(no ``ml_dtypes`` needed).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_like


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Atomically write step checkpoint; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(flatten_with_paths(tree)):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "dtype": dtype_name,
             "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template`` (keys, shapes validated),
    each leaf in its template's dtype and on its device."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    t_leaves = flatten_with_paths(template)
    if len(t_leaves) != len(manifest["leaves"]):
        raise ValueError(f"tree structure changed: {len(t_leaves)} leaves, "
                         f"the checkpoint has {len(manifest['leaves'])}")
    leaves = []
    for (key, tmpl), meta in zip(t_leaves, manifest["leaves"]):
        if key != meta["key"]:
            raise ValueError(f"leaf order mismatch: {key} vs {meta['key']}")
        arr = np.load(os.path.join(d, meta["file"]))
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)}, expected "
                             f"{tuple(tmpl.shape)}")
        leaves.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
    return unflatten_like(template, leaves), step, manifest["extra"]


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted([int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                    if d.startswith("step_")])
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
