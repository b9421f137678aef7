"""Dynamic rate matching + elastic scaling + straggler mitigation (§4.3).

The paper's Fig 9-10 finding: the optimal ctx:gen chip ratio moves with
traffic and latency targets, so a fixed split loses Pareto area. The
``ElasticRateMatcher`` watches queue depth vs decode occupancy on a
``cluster.Cluster`` (driven through the ``policies.ElasticPolicy`` adapter)
and migrates engines between pools at runtime (an engine is role-free:
moving it is a list operation + cache reset). It also:

  - replaces failed engines' capacity by re-balancing the survivors,
  - drains stragglers: engines whose step-time EWMA exceeds
    ``straggler_factor`` x the reference of their *hardware class* are
    demoted (their requests re-queue), mirroring the trainer-side
    StragglerMonitor.

Pools may be hardware-heterogeneous (``Engine.chip``), which changes two
things here:

  - capacity is *weighed*, not counted: a v5p engine is ~2.8 v5e
    equivalents (``Engine.capacity_weight``), so migrating a v5e engine
    into a pool of v5ps moves less capacity than a head count suggests —
    a rebalance must leave ``min_pool`` engines' worth of the source
    pool's own capacity behind, judged *after* the move;
  - straggler detection normalizes step times by each engine's hardware
    class (``Engine.speed_factor``) before comparing: a uniformly-slower
    chip type lands exactly on the pool reference instead of being
    mass-demoted, while a genuine straggler — even the only engine of
    its class — still stands out.
"""
from __future__ import annotations

import dataclasses
from typing import List, TYPE_CHECKING

if TYPE_CHECKING:       # annotation-only: the matcher is backend-agnostic
    from repro_torch.serving.engine import Engine


@dataclasses.dataclass
class ElasticConfig:
    check_every: int = 8              # scheduling rounds between checks
    queue_high: int = 4               # prefill backlog -> grow prefill pool
    occupancy_high: float = 0.9       # decode slots busy -> grow decode pool
    min_pool: float = 1.0             # engines' worth of the pool's own
    #                                   capacity a rebalance must leave
    straggler_factor: float = 4.0


def pool_capacity(pool: List[Engine]) -> float:
    """Healthy serving capacity of a pool in reference-chip equivalents."""
    return sum(e.capacity_weight for e in pool if e.healthy)


class ElasticRateMatcher:
    def __init__(self, cfg: ElasticConfig = ElasticConfig()):
        self.cfg = cfg
        self._round = 0
        self.moves: List[str] = []
        # (backlog, decode occupancy) from the latest rebalance pass — the
        # signal the trace recorder attaches to "rebalance" span events
        self.last_signal = None

    # -- failure handling -------------------------------------------------

    def on_failure(self, orch, dead: Engine):
        """Dead engine: drop from its pool; re-balance if a pool emptied
        (forced — an empty role is worse than a thin one)."""
        for pool in (orch.prefill_pool, orch.decode_pool):
            if dead in pool:
                pool.remove(dead)
        if not orch.prefill_pool and orch.decode_pool:
            self._move(orch, orch.decode_pool, orch.prefill_pool, "failover",
                       force=True)
        if not orch.decode_pool and orch.prefill_pool:
            self._move(orch, orch.prefill_pool, orch.decode_pool, "failover",
                       force=True)

    # -- periodic re-balance ----------------------------------------------

    def maybe_rebalance(self, orch):
        self._round += 1
        if self._round % self.cfg.check_every:
            return
        self.rebalance_now(orch)

    def rebalance_now(self, orch):
        """One straggler-drain + rebalance pass, cadence-free. Round-count
        callers go through ``maybe_rebalance``; virtual-time callers (the
        event loop's ``EV_REBALANCE`` tick via ``ElasticPolicy.tick``)
        call this directly."""
        self._drain_stragglers(orch)
        backlog = orch.ready_count()
        dec = [e for e in orch.decode_pool if e.healthy]
        pre = [e for e in orch.prefill_pool if e.healthy]
        occupancy = (sum(e.active for e in dec)
                     / max(sum(e.slots for e in dec), 1))
        self.last_signal = (backlog, occupancy)
        if (backlog >= self.cfg.queue_high and occupancy < 0.5):
            self._move(orch, orch.decode_pool, orch.prefill_pool,
                       f"backlog={backlog}")
        elif occupancy >= self.cfg.occupancy_high and backlog == 0:
            self._move(orch, orch.prefill_pool, orch.decode_pool,
                       f"occupancy={occupancy:.2f}")

    def _can_release(self, src: List[Engine], eng: Engine) -> bool:
        """Post-move guard: the source pool must keep at least one engine
        and ``min_pool`` engines' worth of *its own* capacity — measured
        against the largest remaining engine's weight, so a uniformly
        slow fleet can still rebalance while a mixed pool never drops
        below ``min_pool`` of its own typical silicon. Degenerates to the
        head-count rule (leave ``min_pool`` engines) on uniform pools."""
        rest = [e for e in src if e.healthy and e is not eng]
        if not rest:
            return False
        unit = max(e.capacity_weight for e in rest)
        return pool_capacity(rest) >= self.cfg.min_pool * unit

    def _move(self, orch, src: List[Engine], dst: List[Engine], why: str,
              *, force: bool = False):
        """Migrate an idle (or least-loaded) healthy engine; among equally
        loaded candidates prefer the chip that suits the destination role —
        compute-rich silicon toward prefill, bandwidth-rich toward decode
        (the multi-vendor-DP placement heuristic). ``force`` skips the
        min-capacity guard (failover)."""
        cands = [e for e in src if e.healthy]
        if not force:
            cands = [e for e in cands if self._can_release(src, e)]
        if not cands:
            return
        to_prefill = dst is orch.prefill_pool

        def fit(e: Engine) -> float:
            if e.chip is None:
                return 0.0
            return e.chip.flops_bf16 if to_prefill else e.chip.hbm_bw

        eng = min(cands, key=lambda e: (e.active, -fit(e), e.engine_id))
        orch.migrate(eng, src, dst)
        self.moves.append(f"{eng.engine_id}:{why}")

    def _drain_stragglers(self, orch):
        for pool in (orch.prefill_pool, orch.decode_pool):
            healthy = [e for e in pool if e.healthy and e.step_times]
            if len(healthy) < 2:
                continue
            # hardware-normalized step times: dividing out speed_factor
            # compares engines as-if on the reference chip, so a uniformly
            # slower class sits on the reference while a genuine straggler
            # (even the only engine of its class) stands out. reference =
            # fastest normalized engine (a median over small pools would
            # be dragged up by the straggler itself).
            norm = {e: e.mean_step_s / e.speed_factor for e in healthy}
            ref = min(norm.values())
            for e in healthy:
                if ref > 0 and norm[e] > self.cfg.straggler_factor * ref:
                    orch.requeue_inflight(e)
                    pool.remove(e)
                    orch.stats.drained_stragglers += 1
                    self.moves.append(f"{e.engine_id}:straggler")
