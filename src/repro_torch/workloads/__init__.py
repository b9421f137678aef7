"""Workload API for ``Cluster.serve()``: the port's copy of
``repro.workloads`` — open-loop arrival processes x shape samplers,
closed-loop multi-turn sessions and JSONL trace replay."""
from repro_torch.workloads.arrivals import (ArrivalProcess, Burst, Diurnal,
                                            Merged, PiecewiseRate, Poisson)
from repro_torch.workloads.base import (BATCH, INTERACTIVE, STANDARD,
                                        Recorder, SLATier, StaticWorkload,
                                        Superpose, Workload, WorkloadSummary,
                                        materialize)
from repro_torch.workloads.generators import OpenLoopWorkload
from repro_torch.workloads.sessions import SessionWorkload
from repro_torch.workloads.shapes import (PATTERN_SHAPES, FixedShape,
                                          LognormalShape, MixtureShape,
                                          ShapeSampler)
from repro_torch.workloads.trace import TraceReplay, record_trace

__all__ = [
    "Workload", "WorkloadSummary", "StaticWorkload", "Superpose",
    "Recorder", "materialize",
    "SLATier", "INTERACTIVE", "STANDARD", "BATCH",
    "ArrivalProcess", "Poisson", "Burst", "PiecewiseRate", "Diurnal",
    "Merged",
    "ShapeSampler", "FixedShape", "LognormalShape", "MixtureShape",
    "PATTERN_SHAPES",
    "OpenLoopWorkload", "SessionWorkload",
    "TraceReplay", "record_trace",
]
