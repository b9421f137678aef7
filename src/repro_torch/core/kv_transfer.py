"""KV-cache transfer bandwidth requirements (paper §5.1, Eqs 1-2, Fig 12).

Egress (prefill side) must keep up with layer-by-layer overlapped transfer
within FTL; ingress (decode side) must land a request's KV within the time
decode spends on one request slot (TTL * OSL). Parallelism schemes that
*duplicate* rather than shard the KV (TP > n_kv_heads) are excluded from the
per-chip normalization — only chips holding distinct shards count.

The port's copy of ``repro.core.kv_transfer``, unchanged but for its
imports of the port's ``core`` modules.
"""
from __future__ import annotations

import dataclasses

from typing import Optional

from repro_torch.core.hardware import (DEFAULT_SYSTEM, HardwareLike, SystemConfig,
                                 as_system)
from repro_torch.core.perf_model import Mapping, PerfLLM, kv_shard_chips


def paged_kv_tokens(isl: int, block_size: int) -> int:
    """Tokens actually shipped per request under a paged KV layout: the
    prompt rounded up to whole blocks (``block_size == 0`` = dense layout,
    exact ISL). The paged serving engine transfers only the request's own
    blocks, so this — not the slot capacity — is the Eq 1-2 numerator."""
    if block_size <= 0:
        return isl
    return -(-isl // block_size) * block_size


@dataclasses.dataclass(frozen=True)
class TransferRequirement:
    egress_bw: float      # B/s per prefill chip (Eq 1)
    ingress_bw: float     # B/s per decode chip (Eq 2)
    kv_bytes_per_request: float
    feasible: bool        # max(egress, ingress) <= provisioned interconnect

    @property
    def max_bw(self) -> float:
        return max(self.egress_bw, self.ingress_bw)


def kv_transfer_requirement(model: PerfLLM, *, isl: int, osl: int,
                            ftl: float, ttl: float,
                            prefill_mapping: Mapping,
                            decode_mapping: Mapping,
                            prefill_batch: int = 1, decode_batch: int = 1,
                            sys_: SystemConfig = DEFAULT_SYSTEM,
                            prefill_sys: Optional[HardwareLike] = None,
                            decode_sys: Optional[HardwareLike] = None,
                            block_size: int = 0) -> TransferRequirement:
    """Eqs 1-2 with the sharding/duplication correction.

    Eq 1: BW_egress  = KV(ISL) * BS_p / (FTL * NumGPU_p^shard)
    Eq 2: BW_ingress = KV(ISL) * BS_d / (TTL * OSL * NumGPU_d^shard)

    ``block_size`` sizes KV(ISL) for a paged layout (block-rounded prompt
    length — what the paged engine actually ships); 0 keeps the dense
    exact-ISL sizing.

    With heterogeneous pools (``prefill_sys`` / ``decode_sys`` override
    ``sys_`` per side), the feasibility check uses the *min* of the two
    pools' per-chip DCN bandwidths — the hop is only as fast as its
    slower endpoint."""
    kv_req_bytes = (model.kv_bytes_per_token()
                    * paged_kv_tokens(isl, block_size))
    n_pre = kv_shard_chips(model, prefill_mapping)
    n_dec = kv_shard_chips(model, decode_mapping)
    egress = kv_req_bytes * prefill_batch / (ftl * n_pre)
    ingress = kv_req_bytes * decode_batch / (ttl * max(osl, 1) * n_dec)
    pre_sys = as_system(prefill_sys, base=sys_) if prefill_sys is not None \
        else sys_
    dec_sys = as_system(decode_sys, base=sys_) if decode_sys is not None \
        else sys_
    provisioned = min(pre_sys.chip.dcn_bw, dec_sys.chip.dcn_bw)
    return TransferRequirement(
        egress_bw=egress, ingress_bw=ingress,
        kv_bytes_per_request=kv_req_bytes,
        feasible=max(egress, ingress) <= provisioned)


def transfer_latency_overlapped(model: PerfLLM, isl: int, ftl: float,
                                prefill_mapping: Mapping,
                                sys_: SystemConfig = DEFAULT_SYSTEM,
                                decode_sys: Optional[HardwareLike] = None,
                                block_size: int = 0) -> float:
    """Exposed (non-overlapped) transfer time under layer-by-layer push:
    only the *last layer's* KV cannot overlap with compute. The push runs
    at the slower endpoint's DCN bandwidth when the decode pool's hardware
    differs (``decode_sys``). ``block_size`` applies paged block-rounding
    to the shipped KV, as in ``kv_transfer_requirement``."""
    per_layer = (model.kv_bytes_per_token()
                 * paged_kv_tokens(isl, block_size) / model.num_layers)
    n_pre = kv_shard_chips(model, prefill_mapping)
    bw = sys_.chip.dcn_bw
    if decode_sys is not None:
        bw = min(bw, as_system(decode_sys, base=sys_).chip.dcn_bw)
    return per_layer / (n_pre * bw)
