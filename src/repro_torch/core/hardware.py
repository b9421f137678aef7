"""Hardware descriptions: the port's copy of ``repro.core.hardware``.

Hardware is a *per-pool* property, not a global constant: the prefill and
decode pools of a disaggregated deployment may run different chips
(compute-rich prefill, bandwidth-rich decode). ``relative_speed`` scales
measured step times onto a chip the host does not have. The port's engine
measures on an H100 and passes ``GPU_H100`` as the reference chip, so an
``h100`` engine's virtual clock reads measured card time unscaled (the JAX
engine's reference is ``TPU_V5E``). All bandwidths are per chip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    name: str
    flops_bf16: float          # FLOP/s
    flops_int8: float
    hbm_bw: float              # B/s
    hbm_cap: float             # bytes
    ici_bw_per_link: float     # B/s, unidirectional
    ici_links: int             # links per chip participating in a collective
    dcn_bw: float              # B/s per chip for cross-pod / pool transfers
    cost_per_hour: float = 1.0  # $/chip-hour (list-price scale; cost-weighted
    #                             frontiers compare tokens/s per dollar)

    @property
    def ici_bw(self) -> float:
        return self.ici_bw_per_link * self.ici_links


TPU_V5E = ChipConfig(
    name="tpu-v5e",
    flops_bf16=197e12,
    flops_int8=394e12,
    hbm_bw=819e9,
    hbm_cap=16 * 2**30,
    ici_bw_per_link=50e9,
    ici_links=4,
    dcn_bw=25e9,
    cost_per_hour=1.2,          # GCP on-demand us-central (public list)
)

TPU_V5P = ChipConfig(
    name="tpu-v5p",
    flops_bf16=459e12,
    flops_int8=918e12,
    hbm_bw=2765e9,
    hbm_cap=95 * 2**30,
    ici_bw_per_link=100e9,
    ici_links=6,
    dcn_bw=25e9,
    cost_per_hour=4.2,          # GCP on-demand us-central (public list)
)

# GPU-class silicon, so sweeps and per-pool --prefill-chip/--decode-chip
# cover the multi-vendor disaggregation setting (ZTE's multi-vendor PD;
# "From Attention to Disaggregation"). The ICI analog is the NVLink
# domain; dcn is the per-GPU scale-out NIC.
GPU_H100 = ChipConfig(
    name="gpu-h100",
    flops_bf16=989e12,          # SXM dense BF16 (NVIDIA H100 datasheet)
    flops_int8=1979e12,         # dense INT8 TOPS
    hbm_bw=3350e9,              # HBM3, 3.35 TB/s
    hbm_cap=80 * 2**30,
    ici_bw_per_link=25e9,       # NVLink4: 18 links x 25 GB/s per direction
    ici_links=18,
    dcn_bw=50e9,                # 400 Gb/s ConnectX-7 per GPU
    cost_per_hour=9.8,          # ~GCP a3-highgpu per-GPU on-demand
)

GPU_A100 = ChipConfig(
    name="gpu-a100",
    flops_bf16=312e12,          # SXM dense BF16 (NVIDIA A100 datasheet)
    flops_int8=624e12,
    hbm_bw=2039e9,              # 80 GB HBM2e, 2.04 TB/s
    hbm_cap=80 * 2**30,
    ici_bw_per_link=25e9,       # NVLink3: 12 links x 25 GB/s per direction
    ici_links=12,
    dcn_bw=25e9,                # 200 Gb/s ConnectX-6 per GPU
    cost_per_hour=3.7,          # ~GCP a2-ultragpu per-GPU on-demand
)


CHIPS: Dict[str, ChipConfig] = {
    "v5e": TPU_V5E,
    "v5p": TPU_V5P,
    "h100": GPU_H100,
    "a100": GPU_A100,
    TPU_V5E.name: TPU_V5E,
    TPU_V5P.name: TPU_V5P,
    GPU_H100.name: GPU_H100,
    GPU_A100.name: GPU_A100,
}

# short registry aliases, for CLI choices= lists
CHIP_NAMES = tuple(sorted(k for k in CHIPS if "-" not in k))


def get_chip(name: str) -> ChipConfig:
    try:
        return CHIPS[name]
    except KeyError:
        raise KeyError(f"unknown chip {name!r}; known: {sorted(CHIPS)}")


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    chip: ChipConfig = TPU_V5E
    ici_domain: int = 256       # chips reachable over ICI (one pod)
    pods: int = 1
    # modelled efficiencies (napkin-level, stated in EXPERIMENTS.md)
    matmul_eff: float = 0.85    # peak-achievable MXU fraction on large GEMMs
    eff_knee_tokens: int = 128  # tokens/chip where MXU eff reaches ~50%
    collective_overlap: float = 0.7  # fraction of collective hidden by compute

    @property
    def total_chips(self) -> int:
        return self.ici_domain * self.pods

    def with_domain(self, n: int) -> "SystemConfig":
        return dataclasses.replace(self, ici_domain=n)

    def with_chip(self, chip: Union[ChipConfig, str]) -> "SystemConfig":
        if isinstance(chip, str):
            chip = get_chip(chip)
        return dataclasses.replace(self, chip=chip)


DEFAULT_SYSTEM = SystemConfig()
TPU_V5P_SYSTEM = SystemConfig(chip=TPU_V5P)

HardwareLike = Union[SystemConfig, ChipConfig, str]


def as_system(hw: HardwareLike, base: SystemConfig = DEFAULT_SYSTEM
              ) -> SystemConfig:
    """Coerce a per-pool hardware spec into a full ``SystemConfig``.

    Accepts a ``SystemConfig`` (returned as-is), a ``ChipConfig``, or a
    registry name ("v5p"); the last two inherit domain size and modelled
    efficiencies from ``base``."""
    if isinstance(hw, SystemConfig):
        return hw
    if isinstance(hw, ChipConfig):
        return dataclasses.replace(base, chip=hw)
    if isinstance(hw, str):
        return dataclasses.replace(base, chip=get_chip(hw))
    raise TypeError(f"expected SystemConfig | ChipConfig | str, got {hw!r}")


def relative_speed(chip: ChipConfig, reference: ChipConfig = TPU_V5E
                   ) -> float:
    """Napkin-grade relative serving speed of ``chip`` vs ``reference``:
    the geometric mean of the compute and HBM-bandwidth speedups (prefill
    is compute-bound, decode memory-bound; one engine does both over its
    lifetime). Used by the executable simulator to scale measured step
    wall-times onto a chip the host does not have."""
    return math.sqrt((chip.flops_bf16 / reference.flops_bf16)
                     * (chip.hbm_bw / reference.hbm_bw))
