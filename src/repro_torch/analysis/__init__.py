"""repro_torch.analysis — the port's architecture & determinism checks.

The port of ``repro.analysis``: the same six static passes and the same
runtime sanitizer, with a policy and baseline of the port's own. They
machine-check the port's invariants instead of trusting convention:

  - ``imports``      AST import-graph checker: layering rules from a
                     checked-in policy (``policy.json``) — the serving
                     runtime / workloads / sweeps / analysis must not
                     import torch (or jax) outside ``TYPE_CHECKING`` or
                     function bodies, nothing of ``repro_torch`` may
                     import jax or the JAX package ``repro`` at all, core
                     and kernels must not import the serving layer;
  - ``determinism``  linter for reproducibility hazards: unseeded rngs,
                     wall-clock reads, set-iteration-order leaks into
                     serialized output, builtin ``sum`` in frontier-area
                     accumulation;
  - ``units``        dimensional consistency inferred from name suffixes
                     in the perf-model and rate-matching arithmetic;
  - ``contracts``    policy-plugin signatures, purity and determinism;
  - ``hotpath``      the per-round serving loop's scans and allocations,
                     budgeted;
  - ``hashstab``     pins ``SweepSpec``/``SweepCell`` content hashes so
                     new spec fields must canonicalize away at defaults
                     (old shards stay cache hits);
  - ``sanitizer``    an opt-in runtime monitor for the ``Cluster`` event
                     loop (``Cluster(sanitize=True)`` or
                     ``REPRO_SANITIZE=1``).

Known-accepted static findings live in ``baseline.json``; the check
fails only on growth. CLI: ``python -m repro_torch.analysis [--json]``.

This package is dependency-light on purpose (stdlib + the repo modules a
check targets): it imports neither torch nor jax.
"""
from repro_torch.analysis.report import (AnalysisResult, Violation,
                                         load_baseline, write_baseline)
from repro_torch.analysis.sanitizer import (ClusterSanitizer, SanitizerError,
                                            assert_stream_parity)

__all__ = ["AnalysisResult", "Violation", "ClusterSanitizer",
           "SanitizerError", "assert_stream_parity", "load_baseline",
           "write_baseline"]
