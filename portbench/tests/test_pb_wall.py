"""The wall-clock metric arithmetic on synthetic stamps, through the
metric readers of ``portbench/metrics``: stalls inside the window move
``itl_p90_s`` and ``output_tokens_per_s``."""
import numpy as np
import pytest

from pbench import spec
from pbench.cell import RunData
from pbench.pacing import Stamps

P = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 1,
     "d_ff": 160, "vocab_size": 96}


def read(name, run):
    fn, variant = spec.reader(name)
    return fn(run, variant)


def steady_run(stall=0.0, n=20, freeze=0.0):
    """Requests due every 0.5 s from t=0; each waits 0.1 s, prefills in
    0.2 s, then emits 10 tokens 0.1 s apart, every fifth of them
    ``stall`` seconds late on the one before (as a prefill run between
    two decode steps delays them), and every token from t=6 on ``freeze``
    seconds late (the loop stopped). The window is [2, 10]."""
    stamps = []
    for i in range(n):
        s = Stamps(i, 100, 11, due=0.5 * i, req=None)
        s.prefill_start = s.due + 0.1
        s.first = s.prefill_start + 0.2
        t, s.tokens = s.first, []
        for k in range(10):
            t += 0.1 + (stall if k % 5 == 4 else 0.0)
            s.tokens.append(t)
        s.tokens = [t + (freeze if t >= 6.0 else 0.0) for t in s.tokens]
        s.done = s.tokens[-1]
        stamps.append(s)
    return RunData(p=P, w0=2.0, w1=10.0, stamps=stamps, prefills=[],
                   decodes=[], td=None, t0=None, t1=None, setup_s=12.5)


def test_setup():
    assert read("setup_s", steady_run()) == 12.5


def test_itl_and_tokens():
    run = steady_run()
    assert read("itl_p90_s", run) == pytest.approx(0.1)
    # tokens in [2, 10]: count the stamps by hand
    n = sum(1 for s in run.stamps for t in [s.first] + s.tokens
            if 2.0 <= t <= 10.0)
    assert read("output_tokens_per_s", run) == pytest.approx(n / 8.0)


def test_stalls_move_itl_and_throughput():
    base, stalled = steady_run(), steady_run(stall=0.5)
    assert read("itl_p90_s", base) == pytest.approx(0.1)
    assert read("itl_p90_s", stalled) == pytest.approx(0.6)
    frozen = steady_run(freeze=1.5)
    assert read("output_tokens_per_s", frozen) < read(
        "output_tokens_per_s", base)
    one = steady_run(n=40)              # one in-window gap stalled alone
    one.stamps[10].tokens[-1] += 3.0
    assert read("itl_p90_s", one) == pytest.approx(0.1)


def test_percentile_is_numpy_linear_over_all_samples():
    run = steady_run(stall=0.05, n=40)
    got = read("itl_p90_s", run)
    gaps = []
    for s in run.stamps:
        ts = [t for t in [s.first] + s.tokens if 2.0 <= t <= 10.0]
        gaps += list(np.diff(ts))
    assert got == pytest.approx(np.percentile(gaps, 90))


def test_step_readers():
    run = steady_run()
    # (wall end, step s, prompt tokens, engine): two prefills in the window
    run.prefills = [(1.0, 0.5, 1000, 0), (3.0, 0.2, 1000, 0),
                    (4.0, 0.3, 500, 0)]
    run.decodes = [(3.5, 0.05, 4, 400, 8), (4.5, 0.07, 4, 404, 8),
                   (11.0, 0.9, 4, 408, 8)]
    assert read("engine.prefill_ms_per_ktok.itl", run) == pytest.approx(
        1e6 * 0.5 / 1500)
    assert read("engine.decode_step_ms.itl", run) == pytest.approx(60.0)
    assert read("cluster.host_share.tput", run) == pytest.approx(
        100 * (1 - 0.62 / 8.0))


def test_readers_find_nothing_without_a_trace():
    run = steady_run()
    for name in ("attn_prefill_roofline.itl", "attn_decode_roofline.itl",
                 "device.idle_share.itl", "device.idle_share.tput"):
        assert read(name, run) is None
    assert read("model.mfu.prefill", run) is None   # no step in the window
