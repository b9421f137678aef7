"""Modality frontend stubs: the port's copy of ``repro.models.frontends``.

Per the assignment, ``[audio]`` / ``[vlm]`` entries specify the transformer
BACKBONE only — the modality frontend is a stub whose outputs appear as
precomputed inputs:

- audio (musicgen): the EnCodec tokenizer is the stub; the backbone consumes
  EnCodec codes directly (vocab=2048), so inputs are plain token ids.
- vision (llava-next): the CLIP tower + anyres tiling is the stub; inputs
  include precomputed patch embeddings [B, P, vision_dim] which the backbone
  projects (2-layer MLP, ``transformer.embed_inputs``) and prepends to the
  text embeddings.

Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins, the port
returns tensors on the ``meta`` device: a shape and a dtype, no storage.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig, ShapeConfig


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a shape cell, in the
    reference's key order: ``tokens`` (and ``labels`` for training), then
    a vision configuration's ``patch_embeds`` [B, P, vision_dim], whose P
    positions come out of the sequence's S."""
    B, S = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        # one token per sequence; the cache is made separately
        return {"tokens": spec((B,), torch.int32)}
    vision = cfg.frontend == "vision"
    P = cfg.vision_patches if vision else 0
    specs = {"tokens": spec((B, S - P), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = spec((B, S), torch.int32)
    if vision:
        specs["patch_embeds"] = spec((B, P, cfg.vision_dim), cfg.tdtype)
    return specs


def synth_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                 device) -> Dict[str, torch.Tensor]:
    """Concrete random inputs matching ``input_specs``, on ``device``:
    drawn from ``np.random.default_rng(seed)`` in the reference's key
    order with its calls, so the integers equal the reference's and the
    patch embeddings (float64 normals cast to the model dtype, the same
    rounding as ``jnp.asarray``) do too."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype.is_floating_point:
            arr = torch.from_numpy(rng.normal(size=tuple(s.shape)))
        else:
            arr = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, size=tuple(s.shape)))
        out[k] = arr.to(s.dtype).to(device)
    return out
