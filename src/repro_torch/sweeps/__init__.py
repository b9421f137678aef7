"""repro_torch.sweeps — vectorized, resumable design-space sweeps.

The paper's methodology is a grid of hundreds of thousands of design
points (models x workloads x hardware); this package is the layer that
makes such grids navigable:

  - ``SweepSpec`` declares the grid and content-addresses it;
  - ``vectorized`` evaluates whole design grids as NumPy arrays
    (scalar-equivalent to ``core.perf_model``, ~20-100x faster);
  - ``SweepStore`` shards results on disk, so interrupted sweeps resume
    and reruns are cache hits;
  - ``run_sweep`` drives cells through worker processes with streaming
    Pareto aggregation;
  - ``SweepResult`` answers frontier / best-hardware / sensitivity
    queries over the persisted records.

See docs/sweeps.md (written for the reference, which this copies). CLI:
``python -m repro_torch.launch.sweep``.
"""
from repro_torch.sweeps.spec import SweepCell, SweepSpec
from repro_torch.sweeps.store import SweepStore
from repro_torch.sweeps.engine import SweepReport, evaluate_cell, run_sweep
from repro_torch.sweeps.result import SweepResult

__all__ = ["SweepCell", "SweepSpec", "SweepStore", "SweepReport",
           "SweepResult", "evaluate_cell", "run_sweep"]
