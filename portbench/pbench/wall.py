"""Wall-clock arithmetic shared by the metric readers.

The window is [w0, w1] on ``time.perf_counter``. A token is in the window
when its stamp is; a step is when it ends there. Percentiles are numpy's
linear interpolation (the port's ``serving.request.percentile``, copied)
over every sample, with no chunking.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def inside(t, run) -> bool:
    return t is not None and run.w0 <= t <= run.w1


def itl(run) -> List[float]:
    """Every gap between two consecutive output tokens of one request, both
    in the window, over all requests."""
    out = []
    for s in run.stamps:
        ts = [t for t in s.token_times() if inside(t, run)]
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def ttft(run) -> List[float]:
    """First token minus due time, for every request whose first token is
    in the window."""
    return [s.first - s.due for s in run.stamps if inside(s.first, run)]


def tokens_in_window(run) -> int:
    return sum(1 for s in run.stamps for t in s.token_times()
               if inside(t, run))
