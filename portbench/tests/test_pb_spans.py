"""The readers of the program's own spans (``engine.decode_host_share``,
``engine.decode_launches``, ``model.moe_share``) on hand-built traces, and
on the card the spans themselves: recorded on the profiler's host
timeline, never copied onto the device's."""
import types

import pytest

from pbench import spec, trace
from pbench.trace import TraceData

DECODE = "repro_torch.engine.decode"
READBACK = "repro_torch.engine.decode.readback"
MOE = "repro_torch.model.moe"


def read(name, td):
    fn, variant = spec.reader(name)
    return fn(types.SimpleNamespace(td=td), variant)


def traced(host_ops, t0=0.0, t1=1000.0):
    return TraceData(device=[("k", 5.0, 6.0)],
                     spans=[("portbench.decode", 0.0, 100.0)],
                     host_ops=host_ops, window_s=(t1 - t0) / 1e6,
                     t0_us=t0, t1_us=t1)


# two decode steps (0-100, 200-300) and a prefill (400-600); a third
# decode step ends after the traced window and is not read
STEPS = [(DECODE, 0.0, 100.0), (DECODE, 200.0, 300.0),
         ("repro_torch.engine.prefill", 400.0, 600.0)]


@pytest.mark.parametrize("name", ["engine.decode_host_share.itl",
                                  "engine.decode_host_share.tput"])
def test_host_share(name):
    td = traced(STEPS + [
        (READBACK, 80.0, 100.0), (READBACK, 250.0, 300.0),
        ("repro_torch.engine.prefill.readback", 550.0, 600.0),
        ("aten::mm", 10.0, 20.0), (DECODE, 900.0, 1100.0),
        (READBACK, 1000.0, 1100.0)])
    # host 80 + 50 of 200 us
    assert read(name, td) == pytest.approx(100.0 * 130.0 / 200.0)


@pytest.mark.parametrize("name", ["engine.decode_launches.itl",
                                  "engine.decode_launches.tput"])
def test_launches_per_step(name):
    launches = [("cudaLaunchKernel", 10.0, 11.0),
                ("cudaLaunchKernel", 20.0, 21.0),
                ("cudaMemcpyAsync", 90.0, 95.0),
                ("cuLaunchKernel", 210.0, 211.0),
                ("cudaLaunchKernelExC_v11060", 220.0, 221.0),
                ("cudaGraphLaunch", 230.0, 231.0),
                ("cuMemsetD32Async_v2", 240.0, 241.0)]
    not_launches = [("cudaStreamSynchronize", 95.0, 99.0),
                    ("cudaLaunchKernel", 150.0, 151.0),     # between steps
                    ("cudaLaunchKernel", 450.0, 451.0),     # in the prefill
                    ("aten::mm", 30.0, 40.0),
                    ("cudaDeviceSynchronize", 290.0, 299.0)]
    td = traced(STEPS + launches + not_launches
                + [(DECODE, 900.0, 1100.0), ("cudaLaunchKernel", 950, 951)])
    assert read(name, td) == pytest.approx(7 / 2)


def test_moe_share():
    td = traced(STEPS + [(MOE, 10.0, 30.0), (MOE, 40.0, 60.0),
                         (MOE, 210.0, 250.0), (MOE, 420.0, 500.0),
                         ("repro_torch.model.mixer", 60.0, 80.0)])
    assert read("model.moe_share.itl", td) == pytest.approx(
        100.0 * 80.0 / 200.0)
    # a dense model's steps have no MoE span
    assert read("model.moe_share.itl", traced(STEPS)) is None


@pytest.mark.parametrize("name", [
    "engine.decode_host_share.itl", "engine.decode_launches.itl",
    "model.moe_share.itl", "engine.decode_host_share.tput",
    "engine.decode_launches.tput"])
def test_nothing_without_spans(name):
    """A program without the spans (the benchmark's own spans and the
    host's ops only), and an untraced run: nothing is read."""
    assert read(name, traced([("aten::mm", 10.0, 20.0),
                              ("cudaLaunchKernel", 12.0, 13.0)])) is None
    assert read(name, None) is None


def _card_engines(moe: bool):
    import torch

    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.serving.backends import init_torch_params, make_engine
    # head size 64, a shape the attention kernels take
    cfg = ModelConfig(name="span-card", family="moe" if moe else "dense",
                      num_layers=2, d_model=256, num_heads=4,
                      num_kv_heads=2, d_ff=512, vocab_size=128,
                      remat=False, dtype="bfloat16",
                      moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                                    capacity_factor=2.0) if moe else None)
    params = init_torch_params(cfg, 0, device="cuda")
    engines = [make_engine("torch", i, cfg, params, slots=4, capacity=96,
                           device="cuda") for i in (0, 1)]
    torch.cuda.synchronize()
    return engines


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_spans_stay_off_the_device_timeline(moe):
    """On the card: a prefill, an insert and decode steps under the
    benchmark's profiler, read by ``trace.read``. The program's spans are
    among the host's ops and none is on the device's timeline; the readers
    read them; every device activity of the decode steps is one launch
    call inside a decode span (run it on the card: ``python -m pytest -m
    gpu -s portbench/tests/test_pb_spans.py``)."""
    import time
    from collections import Counter

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    pre, dec = _card_engines(moe)
    prompt = np.arange(40, dtype=np.int32)
    t = time.perf_counter()
    with trace.profiler() as prof:
        tok, payload = pre.prefill(prompt)
        slot = dec.insert(types.SimpleNamespace(), payload)
        for _ in range(3):
            tok = dec.decode_step({slot: tok})[slot]
        torch.cuda.synchronize()
    td = trace.read(prof, time.perf_counter() - t)
    names = Counter(n for n, _, _ in td.host_ops
                    if n.startswith("repro_torch."))
    assert not [e for e in td.device if e[0].startswith("repro_torch")]
    assert names[DECODE] == 3 and names["repro_torch.engine.prefill"] == 1
    assert names["repro_torch.engine.insert"] == 1
    assert names["repro_torch.model.mixer"] == 2 * 4
    assert names[MOE if moe else "repro_torch.model.ffn"] == 2 * 4
    share = read("engine.decode_host_share.itl", td)
    launches = read("engine.decode_launches.itl", td)
    assert 0.0 < share <= 100.0 and launches > 0
    moe_share = read("model.moe_share.itl", td)
    assert (0.0 < moe_share < 100.0) if moe else moe_share is None

    # decode steps alone: each device activity is one launch call
    with trace.profiler() as prof:
        for _ in range(3):
            tok = dec.decode_step({slot: tok})[slot]
        torch.cuda.synchronize()
    td = trace.read(prof, 1.0)
    api = Counter(n for n, _, _ in td.host_ops if n.startswith("cu"))
    launches = read("engine.decode_launches.itl", td)
    print("span-card " + str({"moe": moe, "share": share,
                              "launches": launches, "moe_share": moe_share,
                              "device": len(td.device), "api": dict(api)}))
    assert launches * 3 == len(td.device)
