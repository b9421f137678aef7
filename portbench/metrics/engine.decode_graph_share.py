"""engine.decode_graph_share.<variant>: the share (%) of the traced decode
steps that replay a CUDA graph: 100 x the program's
``repro_torch.engine.decode`` spans that end inside the traced window and
hold a graph launch (``cudaGraphLaunch`` or ``cuGraphLaunch``, a version
suffix such as ``_v10000`` dropped, as ``engine.decode_launches`` reads
them), over those spans. 100 where every step replays, 0 where every
step is enqueued launch by launch. ``itl`` and ``tput`` read alike.
Nothing is read where the trace holds no decode span (a program without
the spans)."""
import bisect
import re

DECODE = "repro_torch.engine.decode"
GRAPH_LAUNCHES = frozenset(("cudaGraphLaunch", "cuGraphLaunch"))
_VERSION = re.compile(r"(_v\d+)+$")


def read(run, variant):
    td = run.td
    if td is None:
        return None
    steps = [s for s in td.host_ops
             if s[0] == DECODE and td.t0_us <= s[2] <= td.t1_us]
    if not steps:
        return None
    starts = sorted(a for name, a, _ in td.host_ops
                    if _VERSION.sub("", name) in GRAPH_LAUNCHES)
    n = sum(1 for _, a, b in steps
            if bisect.bisect_right(starts, b) > bisect.bisect_left(starts, a))
    return 100.0 * n / len(steps)
