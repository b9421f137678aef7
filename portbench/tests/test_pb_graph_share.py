"""The reader of ``engine.decode_graph_share`` on hand-built traces, beside
``test_pb_spans.py``'s readers of the program's spans."""
import types

import pytest

from pbench import spec
from pbench.trace import TraceData

DECODE = "repro_torch.engine.decode"


def read(name, td):
    fn, variant = spec.reader(name)
    return fn(types.SimpleNamespace(td=td), variant)


def traced(host_ops, t0=0.0, t1=1000.0):
    return TraceData(device=[("k", 5.0, 6.0)],
                     spans=[("portbench.decode", 0.0, 100.0)],
                     host_ops=host_ops, window_s=(t1 - t0) / 1e6,
                     t0_us=t0, t1_us=t1)


# four decode steps in the window and a prefill; a fifth step ends after
# the traced window and is not read
STEPS = [(DECODE, 0.0, 100.0), (DECODE, 200.0, 300.0),
         (DECODE, 400.0, 500.0), (DECODE, 600.0, 700.0),
         ("repro_torch.engine.prefill", 800.0, 900.0),
         (DECODE, 950.0, 1100.0)]


@pytest.mark.parametrize("name", ["engine.decode_graph_share.itl",
                                  "engine.decode_graph_share.tput"])
def test_graph_share(name):
    """Steps holding a graph launch, its version suffix dropped: the first
    (twice: still one step), the third (``cuGraphLaunch``, versioned); the
    second only launches kernels, the fourth's graph launch starts after
    it ends; launches in the prefill and after the window count for
    nothing."""
    ops = [("cudaGraphLaunch", 10.0, 11.0), ("cudaGraphLaunch", 50.0, 51.0),
           ("cudaLaunchKernel", 210.0, 211.0),
           ("cuGraphLaunch_v10000", 410.0, 411.0),
           ("cudaLaunchKernel", 610.0, 611.0),
           ("cudaGraphLaunch", 701.0, 702.0),
           ("cudaGraphLaunch", 850.0, 851.0),
           ("cudaGraphLaunch", 1000.0, 1001.0),
           ("repro_torch.engine.decode.replay", 10.0, 12.0)]
    assert read(name, traced(STEPS + ops)) == pytest.approx(100.0 * 2 / 4)
    # every step eager: 0, not nothing
    assert read(name, traced(STEPS + ops[2:3])) == 0.0


@pytest.mark.parametrize("name", ["engine.decode_graph_share.itl",
                                  "engine.decode_graph_share.tput"])
def test_graph_share_reads_nothing_without_spans(name):
    """A program without the decode spans, and an untraced run: nothing
    is read."""
    assert read(name, traced([("cudaGraphLaunch", 12.0, 13.0)])) is None
    assert read(name, None) is None
