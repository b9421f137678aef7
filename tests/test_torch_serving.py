"""The port's serving runtime vs the JAX package on the CPU: the same
disaggregated ``Cluster.serve`` (1 prefill + 2 decode engines, paged KV
handoff, continuous batching) over the same requests and the same float32
weights gives every request the same greedy token stream; the block pools
account for every block afterwards; the handoff payload is block-rounded.

Equality of token streams is exact: greedy argmax over float32 logits that
agree to ~1e-6 (``tests/test_torch_model.py``) and are nowhere near a tie
at this size. The virtual clocks differ (each side measures its own step
times), so batch composition may differ; the streams may not.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import transformer as JT
from repro.serving.cluster import Cluster as JCluster
from repro.serving.elastic import ElasticConfig as JElasticConfig
from repro.serving.elastic import ElasticRateMatcher as JElasticRateMatcher
from repro.serving.engine import Engine as JEngine
from repro.serving.policies import ElasticPolicy as JElasticPolicy
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.core.hardware import get_chip
from repro_torch.device import resolve_device
from repro_torch.serving.backends import init_torch_params, make_engine
from repro_torch.serving.cluster import Cluster, kv_bytes
from repro_torch.serving.elastic import ElasticConfig, ElasticRateMatcher
from repro_torch.serving.engine import Engine, PagedCache
from repro_torch.serving.policies import ElasticPolicy
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   StaticWorkload, materialize)

ISL, OSL, N_REQ, SLOTS = 24, 6, 6, 2
CAPACITY = ISL + OSL + 8


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_smoke("qwen2.5-3b").replace(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _requests(jax_side: bool, vocab: int):
    if jax_side:
        return jmaterialize(JOpenLoopWorkload(
            JBurst(N_REQ), JFixedShape(ISL, OSL), vocab=vocab, seed=3,
            max_requests=N_REQ, horizon_s=3600.0))
    return materialize(OpenLoopWorkload(
        Burst(N_REQ), FixedShape(ISL, OSL), vocab=vocab, seed=3,
        max_requests=N_REQ, horizon_s=3600.0))


def test_cluster_serve_token_streams_match_reference(weights):
    jcfg, cfg, jp, tp = weights
    jreqs, treqs = _requests(True, cfg.vocab_size), _requests(False,
                                                              cfg.vocab_size)
    assert [r.prompt.tolist() for r in jreqs] == \
        [r.prompt.tolist() for r in treqs]

    jeng = [JEngine(i, jcfg, jp, slots=SLOTS, capacity=CAPACITY)
            for i in (0, 100, 101)]
    jcl = JCluster({"prefill": jeng[:1], "decode": jeng[1:]},
                   rate_matcher=JElasticPolicy(
                       JElasticRateMatcher(JElasticConfig())))
    jm = jcl.serve(JStaticWorkload(jreqs))

    teng = [make_engine("torch", i, cfg, tp, slots=SLOTS, capacity=CAPACITY,
                        chip=get_chip("h100"), device="cpu")
            for i in (0, 100, 101)]
    free0 = [e._alloc.num_free for e in teng]
    tcl = Cluster({"prefill": teng[:1], "decode": teng[1:]},
                  rate_matcher=ElasticPolicy(
                      ElasticRateMatcher(ElasticConfig())))
    tm = tcl.serve(StaticWorkload(treqs))

    assert jm["completed"] == tm["completed"] == N_REQ
    assert {r.rid: r.output for r in treqs} == \
        {r.rid: r.output for r in jreqs}
    assert all(len(r.output) == OSL for r in treqs)
    assert tcl.stats.transfers == jcl.stats.transfers == N_REQ
    assert tcl.stats.transferred_bytes == jcl.stats.transferred_bytes
    # no block leaks: every allocator is back to its initial free count
    assert [e._alloc.num_free for e in teng] == free0
    assert all(not e.slot_req for e in teng)
    assert sum(e.prefills for e in teng) == N_REQ
    assert sum(e.decode_steps for e in teng) >= OSL - 1


def test_paged_cache_nbytes_is_block_rounded(weights):
    jcfg, cfg, jp, tp = weights
    prompt = np.arange(13, dtype=np.int32) % cfg.vocab_size
    eng = Engine(0, cfg, tp, slots=2, capacity=32, device="cpu")
    tok, payload = eng.prefill(prompt)
    assert isinstance(payload, PagedCache) and payload.length == 13
    Lr, Bs = cfg.num_layers, eng.block_size
    nb = -(-13 // Bs)
    assert tuple(payload.blocks["k"].shape) == (
        Lr, nb, Bs, cfg.padded_kv_heads, cfg.dh)
    per_block = Bs * cfg.padded_kv_heads * cfg.dh * 4          # float32
    assert payload.nbytes == 2 * Lr * nb * per_block == kv_bytes(payload)
    jtok, jpayload = JEngine(0, jcfg, jp, slots=2, capacity=32).prefill(
        prompt)
    assert payload.nbytes == jpayload.nbytes and tok == jtok


def test_engine_insert_evict_and_decode_window(weights):
    """Insert takes only the request's blocks, decode grows a block per
    layer at a block boundary, evict returns all of them."""
    _, cfg, _, tp = weights
    eng = Engine(7, cfg, tp, slots=2, capacity=40, device="cpu")
    free0 = eng._alloc.num_free
    _, payload = eng.prefill(np.arange(16, dtype=np.int32))

    class Req:
        slot = engine_id = None

    slot = eng.insert(Req(), payload)
    Lr = cfg.num_layers
    assert eng._alloc.num_free == free0 - Lr * 2 and eng.active == 1
    eng.decode_step({slot: 3})                  # pos 16: a third block
    assert eng._alloc.num_free == free0 - Lr * 3
    assert eng._pos[slot] == 17 and eng.decode_steps == 1
    eng.evict(slot)
    assert eng._alloc.num_free == free0 and eng.has_free_slot()
    assert eng.mean_step_s > 0


def test_engine_surface_and_unported_paths(weights, monkeypatch):
    _, cfg, _, tp = weights
    eng = make_engine("torch", 1, cfg, tp, chip=get_chip("h100"),
                      device="cpu")
    assert eng.speed_factor == 1.0 and eng.capacity_weight == 1.0
    assert eng.prefix_cache is None and eng.paged and eng.impl == "plain"
    assert {"engine_id", "backend", "hardware", "slots", "capacity",
            "paged", "block_size", "speed_factor",
            "capacity_weight"} <= set(eng.describe())
    slow = make_engine("torch", 2, cfg, tp, chip=get_chip("v5e"),
                       device="cpu")
    assert slow.capacity_weight < 1.0           # measured on the reference
    with pytest.raises(NotImplementedError, match="next slice"):
        eng.prefill_chunked(np.arange(8), 8)
    with pytest.raises(NotImplementedError, match="next slice"):
        Engine(3, cfg, tp, paged=False, device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        Engine(3, cfg, tp, chunk_size=16, device="cpu")
    eng.fail()
    with pytest.raises(Exception, match="down"):
        eng.prefill(np.arange(4))
    with pytest.raises(ValueError):
        make_engine("sim", 4, cfg, tp, device="cpu")
    # a bare "cuda" resolves to the indexed device its tensors report
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == resolve_device("cuda") == \
        torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    # no card and no device named: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine("torch", 5, cfg, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_torch_params(cfg, 0)
