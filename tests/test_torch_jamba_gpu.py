"""Card-only checks of the jamba block on the paged, graphed path: its
graphs and spans under the benchmark's profiler at a smoke size, and the
jamba cell's traced prefills as ``model.ssm_share`` reads them. Marked
``gpu``: each test asks the ``cuda`` fixture for the card and skips where
there is none. The file imports torch only, so on the card it runs as

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_jamba_gpu.py
"""
import gc
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
for _p in (_BENCH, os.path.join(_BENCH, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from pbench import cell, spec, trace  # noqa: E402
from test_pb_jamba import FAULTS  # noqa: E402  (the engine's faults)

from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.serving.backends import (init_torch_params,  # noqa: E402
                                          make_engine)

pytestmark = pytest.mark.gpu

CELL = "jamba2-mini.prefill-heavy.saturated"
SSM = "repro_torch.model.ssm"
SCAN = "repro_torch.ssm.scan"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    gc.collect()            # a cell's 58 GB of weights go before the next
    torch.cuda.empty_cache()


def _cfg() -> ModelConfig:
    # one period of Jamba's layers at head size 64 (a shape the attention
    # kernels take), 8 of 16 experts held; bf16
    return ModelConfig(
        name="jamba-card", family="hybrid", num_layers=8, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=160, remat=False,
        dtype="bfloat16", block="jamba", attn_layer_period=8,
        attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        rope=False, ssm_expand=2, ssm_dt_rank=16, ssm_conv_bias=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128,
                      capacity_factor=8.0, router_experts=16,
                      renormalize=False))


def _ssm_share(td):
    mod = spec.reader("model.ssm_share.tput")[0].__globals__
    return mod["prefills"](td), mod["read"](types.SimpleNamespace(td=td),
                                            "tput")


def test_spans_and_graphs_under_the_profiler(cuda):
    """Prefills of 600 and 40 tokens (three chunks of the scan and one),
    an insert and 6 decode steps under the profiler: the program's spans
    stay off the device's timeline; each prefill opens ``model.ssm`` and
    ``ssm.scan`` once a Mamba-1 layer (the capturing step its
    ``model.ssm`` too); one capture for the window met and one replay a
    step; each prefill's launch calls pair with its device activities
    kind for kind, and ``model.ssm_share`` reads a share."""
    cfg = _cfg()
    params = init_torch_params(cfg, 0, device="cuda")
    pre, dec = (make_engine("torch", i, cfg, params, slots=4, capacity=704,
                            device="cuda") for i in range(2))
    Lm = len(cfg.mamba_layer_ids)
    with trace.profiler():                  # the profiler's own first start
        torch.ones(1, device=cuda).add_(1)
        torch.cuda.synchronize()
    t = time.perf_counter()
    with trace.profiler() as prof:
        tok, payload = pre.prefill(np.arange(600, dtype=np.int32) % 160)
        tok, payload = pre.prefill(np.arange(40, dtype=np.int32))
        slot = dec.insert(types.SimpleNamespace(), payload)
        for _ in range(6):
            tok = dec.decode_step({slot: tok})[slot]
        torch.cuda.synchronize()
    td = trace.read(prof, time.perf_counter() - t)
    names = Counter(n for n, _, _ in td.host_ops
                    if n.startswith("repro_torch."))
    assert not [e for e in td.device if e[0].startswith("repro_torch")]
    assert names["repro_torch.engine.prefill"] == 2
    assert names[SCAN] == 2 * Lm
    assert names[SSM] == 3 * Lm                 # two prefills, one capture
    assert dec.graph_captures == 1 and dec.graph_replays == 6
    assert names["repro_torch.engine.decode.replay"] == 6
    pairs, share = _ssm_share(td)
    print("jamba-card " + str({"paired": [p is not None and len(p[0])
                                          for p in pairs],
                               "ssm_share": share}))
    assert len(pairs) == 2 and None not in pairs
    assert 0.0 < share < 100.0


def test_the_cell_s_traced_prefills_pair_their_launches(cuda):
    """The jamba cell at its published widths, traced after a short ramp
    and window: in every traced prefill the launch calls pair with the
    device activities kind for kind, so ``model.ssm_share`` reads all of
    them; every decode step replays a graph."""
    bench = cell.Bench(CELL, 4100000007, t_start=time.perf_counter(),
                       device="cuda", traced=True, log=lambda s: None)
    run = bench.serve(dict(bench.mix, ramp_s=8), 6.0)
    pairs, share = _ssm_share(run.td)
    graphs = spec.reader("engine.decode_graph_share.tput")
    print("jamba-cell " + str({"paired": [p is not None and len(p[0])
                                          for p in pairs],
                               "ssm_share": share,
                               "graph_share": graphs[0](run, graphs[1])}))
    assert pairs and None not in pairs
    assert 0.0 < share < 100.0
    assert graphs[0](run, graphs[1]) == 100.0


def _experts_offset(orig):
    def model_config(p):
        cfg = orig(p)
        return cfg.replace(moe=cfg.moe.replace(first_expert=8))
    return model_config


@pytest.mark.parametrize("fault", list(FAULTS) + ["experts_offset"])
def test_fault_is_caught_on_the_card(cuda, monkeypatch, fault):
    """Each fault planted in the jamba cell at its size and load (its
    30-s ramp, then a 10-s window), judged by the cell's own limits: the
    handed-off SSM state zeroed, its convolution state dropped, a slot
    given another slot's state (``test_pb_jamba.FAULTS``), the held
    experts taken for experts 8-15. Prints every number."""
    import json

    from repro_torch.serving import engine as E
    if fault == "experts_offset":
        monkeypatch.setattr(cell, "model_config",
                            _experts_offset(cell.model_config))
    else:
        monkeypatch.setattr(E.Engine, "insert",
                            FAULTS[fault](E.Engine.insert))
    bench = cell.Bench(CELL, 4100000001, t_start=time.perf_counter(),
                       device="cuda", log=lambda s: None)
    out = bench.check(bench.serve(bench.mix, 10.0))
    print("fault-reading " + json.dumps({
        "fault": fault, "correct": out["correct"], "served": out["served"],
        "sampled": out["sampled"], "values": out["values"]}), flush=True)
    assert not out["correct"], out["checks"]
    assert any(r["value"] > r["limit"] for k, r in out["checks"].items()
               if k != "served_tokens_min"), out["checks"]
