"""Card-only checks of the paged decode step's CUDA graphs
(``serving/graphs.py``): a graphed engine against an eager one on the same
weights, and the graphed step under the benchmark's profiler. Marked
``gpu``: each test asks the ``cuda`` fixture for the card and skips where
there is none. The file imports torch only, so on the card it runs as

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_decode_graph_gpu.py
"""
import os
import sys
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if _BENCH not in sys.path:
    sys.path.insert(0, _BENCH)

from pbench import pacing, spec, trace  # noqa: E402

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.serving.backends import (init_torch_params,  # noqa: E402
                                          make_engine)
from repro_torch.serving.engine import window_blocks  # noqa: E402

pytestmark = pytest.mark.gpu

DECODE = "repro_torch.engine.decode"
REPLAY = "repro_torch.engine.decode.replay"
MODEL_SPANS = ("repro_torch.model.mixer", "repro_torch.model.ffn",
               "repro_torch.model.moe", "repro_torch.model.logits")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(kind: str) -> ModelConfig:
    # head size 64, a shape the attention kernels take; bf16
    if kind == "jamba":     # one period of Jamba's layers, 8 of 16 experts
        return ModelConfig(
            name="graph-card-jamba", family="hybrid", num_layers=8,
            d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
            vocab_size=160, remat=False, dtype="bfloat16", block="jamba",
            attn_layer_period=8, attn_layer_offset=4, expert_layer_period=2,
            expert_layer_offset=1, rope=False, ssm_expand=2, ssm_dt_rank=16,
            ssm_conv_bias=True,
            moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128,
                          capacity_factor=8.0, router_experts=16,
                          renormalize=False))
    moe = kind == "moe"
    return ModelConfig(name="graph-card", family="moe" if moe else "dense",
                       num_layers=3, d_model=256, num_heads=4,
                       num_kv_heads=2, d_ff=512, vocab_size=160,
                       remat=False, dtype="bfloat16",
                       moe=MoEConfig(num_experts=8, top_k=2,
                                     d_ff_expert=128, capacity_factor=4.0)
                       if moe else None)


def _engines(cfg, n: int, slots: int = 8, capacity: int = 256):
    params = init_torch_params(cfg, 0, device="cuda")
    engines = [make_engine("torch", i, cfg, params, slots=slots,
                           capacity=capacity, device="cuda")
               for i in range(n)]
    torch.cuda.synchronize()
    return engines


class _Logits:
    """Records the full logits of every ``decode_step_paged`` call (a
    clone: a replay's logits are the graph's own tensor)."""

    def __init__(self):
        self.rows = []
        self.fn = T.decode_step_paged

    def __enter__(self):
        def wrapped(*a, **kw):
            out = self.fn(*a, **kw)
            self.rows.append(out[0].clone())
            return out
        T.decode_step_paged = wrapped
        return self

    def __exit__(self, *exc):
        T.decode_step_paged = self.fn


@pytest.mark.parametrize("kind", ["dense", "moe", "jamba"])
def test_graphed_engine_equals_eager(cuda, kind):
    """24 decode steps on a graphed engine and on an eager one (its graphs
    taken away) with the same weights and the same handoffs: a 12-token
    request alone, a 60-token one joining at step 8 and leaving at step
    16, so that the window runs 2, 4, 8, 16 blocks and back to 4 and 8.
    The same tokens and logits equal to the bit (the same kernels on the
    same shapes; cuBLAS chooses by shape, not by stream). With the
    benchmark's logit capture installed every replayed step leaves its
    row maxima; one capture a window met, one replay a step; the paged
    kernel's launch count advances by a layer's worth each step either
    way; the captures stay off the step times. A jamba engine's SSM state
    is stepped in place inside the replay."""
    cfg = _cfg(kind)
    pre, graphed, eager = _engines(cfg, 3)
    eager._graphs = None
    assert graphed.graph_captures == graphed.graph_replays == 0
    rng = np.random.default_rng(7)
    short, long_ = (pre.prefill(rng.integers(0, cfg.vocab_size, n)
                                .astype(np.int32)) for n in (12, 60))
    box = {}
    undo = pacing.capture(T, box)
    try:
        toks = {eng: {eng.insert(types.SimpleNamespace(), short[1]):
                      short[0]} for eng in (graphed, eager)}
        joined = {}
        windows = []
        for step in range(24):
            for eng in (graphed, eager):
                if step == 8:
                    joined[eng] = eng.insert(types.SimpleNamespace(),
                                             long_[1])
                    toks[eng][joined[eng]] = long_[0]
                if step == 16:
                    eng.evict(joined[eng])
                    del toks[eng][joined[eng]]
            windows.append(window_blocks(
                max(int(graphed._pos[s]) for s in toks[graphed]),
                graphed.block_size, graphed._nb_max))
            rows = {}
            for eng in (graphed, eager):
                n0 = dec_ops.decode_attention_paged.launches
                box.pop("max", None)
                with _Logits() as rec:
                    toks[eng] = eng.decode_step(toks[eng])
                assert torch.equal(box["max"], rec.rows[0].amax(dim=-1))
                assert (dec_ops.decode_attention_paged.launches
                        == n0 + len(cfg.attn_layer_ids))
                rows[eng] = rec.rows[0]
            assert toks[graphed] == toks[eager], step
            assert torch.equal(rows[graphed], rows[eager]), step
    finally:
        undo()
    assert windows[:4] == [2] * 4 and windows[8] == 8 and 16 in windows
    assert windows[16] == 4 and windows[-1] == 8
    assert graphed.graph_captures == len(set(windows)) == 4
    assert graphed.graph_replays == 24
    # the captures stay off the measured step times (the straggler
    # detector's input): the graphed steps, capturing ones included, take
    # less than the eager ones
    assert graphed.mean_step_s < eager.mean_step_s
    assert eager.graph_captures == eager.graph_replays == 0
    d = graphed.describe()
    assert (d["graph_captures"], d["graph_replays"]) == (4, 24)


def test_moved_pool_is_refused(cuda):
    """A replay whose block pool no longer sits where the capture read it
    raises instead of reading freed memory."""
    pre, dec = _engines(_cfg("dense"), 2)
    tok, payload = pre.prefill(np.arange(12, dtype=np.int32))
    slot = dec.insert(types.SimpleNamespace(), payload)
    tok = dec.decode_step({slot: tok})[slot]
    dec.pool = {k: v.clone() for k, v in dec.pool.items()}
    with pytest.raises(RuntimeError, match="moved"):
        dec.decode_step({slot: tok})


def _read(name, td):
    fn, variant = spec.reader(name)
    return fn(types.SimpleNamespace(td=td), variant)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_replayed_steps_under_the_profiler(cuda, kind):
    """The benchmark's order: the profiler started once before any
    capture, then a prefill, an insert and decode steps (the first
    captures) under it. The program's spans stay off the device's
    timeline; each decode step holds one ``cudaGraphLaunch`` and its
    replay span; the model's spans open in the prefill and the capturing
    step only; every replay's kernels are on the device's timeline (the
    paged kernel once a layer a step, what ``attn_decode_roofline``
    counts); over replays alone the graph share reads 100, the launches a
    handful."""
    import torch.profiler  # noqa: F401
    moe = kind == "moe"
    cfg = _cfg(kind)
    pre, dec = _engines(cfg, 2, slots=4, capacity=96)
    with trace.profiler():                  # the profiler's own first start
        torch.ones(1, device=cuda).add_(1)
        torch.cuda.synchronize()
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
    assert names[DECODE] == 3 and names[REPLAY] == 3
    assert names["repro_torch.engine.prefill"] == 1
    assert names["repro_torch.engine.insert"] == 1
    assert dec.graph_captures == 1 and dec.graph_replays == 3
    L = cfg.num_layers
    # the prefill's layers and the capturing step's: 2 x L
    assert names["repro_torch.model.mixer"] == 2 * L
    assert names["repro_torch.model.moe" if moe
                 else "repro_torch.model.ffn"] == 2 * L
    assert len(td.kernels("paged_decode_kernel")) == 3 * L

    # replays alone
    with trace.profiler() as prof:
        for _ in range(4):
            tok = dec.decode_step({slot: tok})[slot]
        torch.cuda.synchronize()
    td = trace.read(prof, 1.0)
    names = Counter(n for n, _, _ in td.host_ops
                    if n.startswith("repro_torch."))
    api = Counter(n for n, _, _ in td.host_ops if n.startswith("cu"))
    graph_launches = sum(v for k, v in api.items()
                         if k.startswith(("cudaGraphLaunch",
                                          "cuGraphLaunch")))
    share = _read("engine.decode_graph_share.itl", td)
    launches = _read("engine.decode_launches.itl", td)
    print("graph-card " + str({"moe": moe, "launches": launches,
                               "share": share, "device": len(td.device),
                               "api": dict(api)}))
    assert not [n for n in names if n in MODEL_SPANS]
    assert names[DECODE] == names[REPLAY] == 4 and graph_launches == 4
    assert share == 100.0
    assert launches <= 16
    assert len(td.kernels("paged_decode_kernel")) == 4 * L
    assert len(td.kernels("split_merge_kernel")) == 4 * L
    assert 0.0 < _read("engine.decode_host_share.itl", td) <= 100.0
