"""Architecture registry: --arch <id> -> ModelConfig (full + smoke).

The port's copy of ``repro.configs``: the same ten ids in the same order,
each configuration field for field the reference's, and the same helpers
(``all_configs``, ``get_shape``, ``cells``). Every id resolves here, so the
simulator and the sweep price all ten; what the torch backend serves is
for ``transformer.unported`` and the launcher to say (the full-size
``kimi-k2-1t-a32b`` and ``mistral-large-123b`` wait for sharding)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skips: bool = False):
    """All assigned (arch x shape) cells, with long_500k applicability.

    Yields (arch, shape_name, runnable: bool, reason)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                if include_skips:
                    yield arch, shape.name, False, (
                        "pure full-attention arch: 512k dense-KV decode "
                        "skipped per assignment (see DESIGN.md)")
                continue
            yield arch, shape.name, True, ""
