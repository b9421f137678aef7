"""engine.decode_launches.<variant>: the host's launch calls per traced
decode step: the CUDA runtime's and driver's calls that put work on the
device (kernel launches, asynchronous copies and sets, graph launches:
``LAUNCHES``, a version suffix such as ``_v2`` dropped) that start inside
the program's ``repro_torch.engine.decode`` spans, over the number of
those spans that end inside the traced window. Set by the shapes and the
code, not by noise; a CUDA graph of the step would take it to a handful.
``itl`` and ``tput`` read alike. Nothing is read where the trace holds no
decode span (a program without the spans)."""
import bisect
import re

DECODE = "repro_torch.engine.decode"
LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemcpy",
    "cudaMemset", "cudaGraphLaunch",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
    "cuMemcpyAsync", "cuMemcpyHtoDAsync", "cuMemcpyDtoHAsync",
    "cuMemcpyDtoDAsync", "cuMemsetD8Async", "cuMemsetD16Async",
    "cuMemsetD32Async", "cuGraphLaunch"))
_VERSION = re.compile(r"(_v\d+)+$")


def is_launch(name: str) -> bool:
    return _VERSION.sub("", name) in LAUNCHES


def read(run, variant):
    td = run.td
    if td is None:
        return None
    steps = [s for s in td.host_ops
             if s[0] == DECODE and td.t0_us <= s[2] <= td.t1_us]
    if not steps:
        return None
    starts = sorted(a for name, a, _ in td.host_ops if is_launch(name))
    n = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
            for _, a, b in steps)
    return n / len(steps)
