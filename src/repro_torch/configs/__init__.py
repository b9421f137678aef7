"""Architecture registry: --arch <id> -> ModelConfig (full + smoke).

The port registers the architectures whose families it serves: the
dense-attention family's ``qwen2.5-3b``, ``qwen3-14b`` (qk_norm) and
``phi3-medium-14b``, the MoE family's ``granite-moe-1b-a400m`` (one card
holds it; ``kimi-k2-1t-a32b`` waits for sharding), and the RWKV-6
family's ``rwkv6-1.6b``."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).SMOKE
