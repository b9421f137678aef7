"""The port's serving runtime vs the JAX package on the CPU: the same
``Cluster.serve`` over the same requests and the same float32 weights
gives every request the same greedy token stream — disaggregated (paged
KV handoff, continuous batching, and the dense layout), co-located
(chunked prefill with decode piggybacked between chunks) and
prefix-affine over multi-turn sessions, and the attention-free RWKV-6
family with its recurrent state handed over; the block pools account for
every block afterwards; the handoff payloads have the reference's sizes.

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
from repro.models.config import ModelConfig as JModelConfig
from repro.models import transformer as JT
from repro.serving.cluster import Cluster as JCluster
from repro.serving.elastic import ElasticConfig as JElasticConfig
from repro.serving.elastic import ElasticRateMatcher as JElasticRateMatcher
from repro.serving.engine import Engine as JEngine
from repro.serving.policies import \
    ChunkedPiggybackScheduler as JChunkedPiggybackScheduler
from repro.serving.policies import ElasticPolicy as JElasticPolicy
from repro.serving.policies import KVLocalityRouter as JKVLocalityRouter
from repro.serving.policies import \
    PrefixAffinityScheduler as JPrefixAffinityScheduler
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import Poisson as JPoisson
from repro.workloads import SessionWorkload as JSessionWorkload
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.core.hardware import get_chip
from repro_torch.device import resolve_device
from repro_torch.models.config import MoEConfig, ModelConfig
from repro_torch.serving.backends import init_torch_params, make_engine
from repro_torch.serving.blocks import BlockPoolExhausted
from repro_torch.serving.cluster import Cluster, kv_bytes
from repro_torch.serving.elastic import ElasticConfig, ElasticRateMatcher
from repro_torch.serving.engine import Engine, PagedCache, PrefixBlocks
from repro_torch.serving.policies import (ChunkedPiggybackScheduler,
                                          ElasticPolicy, KVLocalityRouter,
                                          PrefixAffinityScheduler)
from repro_torch.serving.request import Request
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   Poisson, SessionWorkload, StaticWorkload,
                                   materialize)

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
    dense = make_engine("torch", 3, cfg, tp, paged=False, chunk_size=16,
                        device="cpu")
    assert not dense.paged and dense.prefix_cache is not None
    assert dense.describe()["block_size"] == 0
    with pytest.raises(ValueError, match="block_size"):
        Engine(3, cfg, tp, chunk_size=12, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        eng.prefill_chunked(np.arange(250) % 100, 24)  # pads to 264 > 256
    # what is still unported names the slice that brings it; MoE, the
    # hybrid family and kv-quant, whose slices have landed, are accepted
    # (a hybrid or kv-quant engine in the dense layout only, as the
    # reference's)
    hybrid = cfg.replace(block="hybrid")
    with pytest.raises(NotImplementedError, match="later slice"):
        Engine(4, cfg.replace(sliding_window=8), tp, device="cpu")
    kvq = cfg.replace(kv_quant=True)
    assert not Engine(4, kvq, tp, device="cpu").paged
    with pytest.raises(ValueError, match="paged KV unsupported"):
        Engine(4, kvq, tp, paged=True, device="cpu")
    hybrid_p = init_torch_params(hybrid, 0, device="cpu")
    assert not Engine(4, hybrid, hybrid_p, device="cpu").paged
    assert not Engine(4, hybrid, hybrid_p, paged=False, device="cpu").paged
    with pytest.raises(ValueError, match="paged KV unsupported"):
        Engine(4, hybrid, hybrid_p, paged=True, device="cpu")
    moe = cfg.replace(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32))
    moe_p = init_torch_params(moe, 0, device="cpu")
    for paged in (True, False):
        assert Engine(4, moe, moe_p, paged=paged, device="cpu").paged == paged
    eng.fail()
    with pytest.raises(Exception, match="down"):
        eng.prefill(np.arange(4))
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine("weird", 4, cfg, tp, device="cpu")
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


# ---------------------------------------------------------------------------
# Co-located, dense and prefix-affine serving

CHUNK = 8


def _streams(reqs):
    return {r.rid: list(r.output) for r in reqs}


def _free(engines):
    return [e._alloc.num_free for e in engines if e.paged]


def test_coloc_serve_token_streams_match_reference(weights):
    """One mixed pool, chunked prefill with a decode round piggybacked
    after every chunk, kv-locality routing: the same streams as the JAX
    runtime, no KV transfer, no leaked block."""
    jcfg, cfg, jp, tp = weights
    jreqs, treqs = _requests(True, cfg.vocab_size), _requests(False,
                                                              cfg.vocab_size)
    jeng = [JEngine(i, jcfg, jp, slots=SLOTS, capacity=CAPACITY)
            for i in (0, 1)]
    jcl = JCluster({"mixed": jeng},
                   scheduler=JChunkedPiggybackScheduler(CHUNK),
                   router=JKVLocalityRouter())
    jm = jcl.serve(JStaticWorkload(jreqs))
    teng = [make_engine("torch", i, cfg, tp, slots=SLOTS, capacity=CAPACITY,
                        device="cpu") for i in (0, 1)]
    free0 = _free(teng)
    tcl = Cluster({"mixed": teng}, scheduler=ChunkedPiggybackScheduler(CHUNK),
                  router=KVLocalityRouter())
    tm = tcl.serve(StaticWorkload(treqs))
    assert jm["completed"] == tm["completed"] == N_REQ
    assert _streams(treqs) == _streams(jreqs)
    assert tcl.stats.transfers == jcl.stats.transfers == 0
    assert _free(teng) == free0 and all(not e.slot_req for e in teng)
    assert sum(e.prefills for e in teng) == N_REQ


def test_coloc_streams_equal_disagg_streams(weights):
    """Deployment shape must not change what gets generated
    (``tests/test_serving.py:257``): a mixed pool with whole-prompt
    prefill, and one with chunked piggyback prefill, give the disaggregated
    cluster's streams."""
    _, cfg, _, tp = weights
    runs = {}
    for name in ("disagg", "coloc", "coloc-chunked"):
        reqs = _requests(False, cfg.vocab_size)
        engs = [make_engine("torch", i, cfg, tp, slots=SLOTS,
                            capacity=CAPACITY, device="cpu") for i in (0, 1)]
        if name == "disagg":
            cl = Cluster({"prefill": engs[:1], "decode": engs[1:]})
        else:
            cl = Cluster({"mixed": engs}, router=KVLocalityRouter(),
                         **({"scheduler": ChunkedPiggybackScheduler(CHUNK)}
                            if name == "coloc-chunked" else {}))
        assert cl.serve(StaticWorkload(reqs))["completed"] == N_REQ
        runs[name] = _streams(reqs)
    assert runs["coloc"] == runs["disagg"] == runs["coloc-chunked"]


def test_dense_layout_serve_matches_reference_and_paged(weights):
    """Dense engines serve the JAX dense engines' streams, and (at a pow2
    capacity, ``tests/test_paged.py:81``) the paged engines' streams; the
    dense handoff payload is capacity-wide, as the reference's."""
    jcfg, cfg, jp, tp = weights
    cap = 64
    jreqs = _requests(True, cfg.vocab_size)
    jeng = [JEngine(i, jcfg, jp, slots=SLOTS, capacity=cap, paged=False)
            for i in (0, 1)]
    JCluster({"prefill": jeng[:1], "decode": jeng[1:]}).serve(
        JStaticWorkload(jreqs))
    runs = {}
    for paged in (False, True):
        reqs = _requests(False, cfg.vocab_size)
        engs = [make_engine("torch", i, cfg, tp, slots=SLOTS, capacity=cap,
                            paged=paged, device="cpu") for i in (0, 1)]
        free0 = _free(engs)
        cl = Cluster({"prefill": engs[:1], "decode": engs[1:]})
        assert cl.serve(StaticWorkload(reqs))["completed"] == N_REQ
        assert _free(engs) == free0             # no leaked blocks
        runs[paged] = (_streams(reqs), cl.stats.transferred_bytes)
    assert runs[False][0] == _streams(jreqs) == runs[True][0]
    per_tok = 2 * cfg.num_layers * cfg.padded_kv_heads * cfg.dh * 4
    assert runs[False][1] == N_REQ * cap * per_tok      # capacity-wide
    assert runs[True][1] == N_REQ * ISL * per_tok       # block-rounded


def _sessions(jax_side: bool, vocab: int):
    kw = dict(vocab=vocab, seed=4, sessions=3, turns=2, families=1,
              system_prefix_len=16, user_isl=(5, 12), osl=4,
              think_time=0.01)
    return JSessionWorkload(**kw) if jax_side else SessionWorkload(**kw)


@pytest.mark.parametrize("paged", [True, False])
def test_prefix_affinity_sessions_match_reference(weights, paged):
    """Multi-turn sessions on a mixed pool with prefix-affinity and
    chunked prefill: later turns and sibling sessions hit the prefix
    cache, the streams equal the JAX runtime's (a hit resumes from the
    same KV a fresh prefill computes), and clearing the caches returns
    every block."""
    jcfg, cfg, jp, tp = weights
    jw, tw = _sessions(True, cfg.vocab_size), _sessions(False,
                                                         cfg.vocab_size)
    cap = tw.max_context() + 8 + CHUNK - 1
    jeng = [JEngine(i, jcfg, jp, slots=SLOTS, capacity=cap,
                    chunk_size=CHUNK, paged=paged) for i in (0, 1)]
    jrec, trec = [], []
    jw.on_complete = _recording(jw.on_complete, jrec)
    tw.on_complete = _recording(tw.on_complete, trec)
    JCluster({"mixed": jeng}, scheduler=JPrefixAffinityScheduler(CHUNK),
             router=JKVLocalityRouter()).serve(jw)
    teng = [make_engine("torch", i, cfg, tp, slots=SLOTS, capacity=cap,
                        chunk_size=CHUNK, paged=paged, device="cpu")
            for i in (0, 1)]
    free0 = _free(teng)
    tm = Cluster({"mixed": teng}, scheduler=PrefixAffinityScheduler(CHUNK),
                 router=KVLocalityRouter()).serve(tw)
    assert tm["completed"] == len(trec) == len(jrec) == 6
    key = (lambda r: (r.session_id, r.turn))
    assert {key(r): (r.prompt.tolist(), r.output) for r in trec} == \
        {key(r): (r.prompt.tolist(), r.output) for r in jrec}
    assert sum(e.prefix_cache.hits for e in teng) > 0
    assert sum(e.prefix_cache.hits for e in jeng) > 0
    for e in teng:
        while e.prefix_cache.pop_lru():
            pass
    assert _free(teng) == free0 and all(not e.slot_req for e in teng)


def _recording(on_complete, out):
    def wrapped(req, now):
        out.append(req)
        on_complete(req, now)
    return wrapped


def test_prefix_blocks_shared_by_refcount(weights):
    """A hit references the entry's blocks and allocates only the suffix;
    two entries share their common blocks (refcount 2), never a copy."""
    _, cfg, _, tp = weights
    eng = Engine(0, cfg, tp, slots=2, capacity=64, chunk_size=8,
                 device="cpu")
    free0 = eng._alloc.num_free
    rng = np.random.default_rng(1)
    a = rng.integers(1, cfg.vocab_size, 24).astype(np.int32)
    b = np.concatenate([a[:16], rng.integers(1, cfg.vocab_size, 8)
                        .astype(np.int32)])
    eng.prefill_chunked(a, 8)
    eng.prefill_chunked(b, 8)                   # shares a's first 16 tokens
    assert eng.prefix_cache.hits == 1 and len(eng.prefix_cache) == 2
    Lr = cfg.num_layers
    assert free0 - eng._alloc.num_free == Lr * 4     # 3 + 1 distinct/layer
    shared = eng.prefix_cache.lookup(a)[0]
    assert isinstance(shared, PrefixBlocks) and shared.length == 24
    for blk in shared.ids[:, :2].ravel().tolist():
        assert eng._alloc.refcount(blk) == 2
    assert eng.prefix_cache.pop_lru()           # evicts a (LRU)
    assert free0 - eng._alloc.num_free == Lr * 3
    assert eng.prefix_cache.pop_lru()
    assert eng._alloc.num_free == free0


def test_prefix_entries_trimmed_to_true_length(weights):
    """Entries store the chunk-aligned true prompt prefix, never pad KV,
    on both layouts; the dense entry is a copy, not a view of the
    capacity-wide cache; resuming from it reproduces the fresh token."""
    _, cfg, _, tp = weights
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, 17).astype(np.int32)  # pads 24
    dense = Engine(0, cfg, tp, slots=2, capacity=64, chunk_size=8,
                   paged=False, device="cpu")
    _, cache = dense.prefill_chunked(prompt, 8)
    entry = next(iter(dense.prefix_cache._entries.values()))
    assert entry["k"].shape[2] == 16 and int(entry["pos"][0]) == 16
    assert entry["k"].untyped_storage().data_ptr() != \
        cache["k"].untyped_storage().data_ptr()
    assert int(cache["pos"][0]) == 24           # the padded prompt
    paged = Engine(1, cfg, tp, slots=2, capacity=64, chunk_size=8,
                   device="cpu")
    free0 = paged._alloc.num_free
    _, payload = paged.prefill_chunked(prompt, 8)
    assert payload.length == 24 and payload.blocks["k"].shape[1] == 3
    pentry = paged.prefix_cache.lookup(prompt)[0]
    assert pentry.length == 16 and pentry.ids.shape == (cfg.num_layers, 2)
    assert free0 - paged._alloc.num_free == cfg.num_layers * 2
    follow = np.concatenate([prompt[:16], rng.integers(1, cfg.vocab_size, 9)
                             .astype(np.int32)])
    for layout in (False, True):
        warm = Engine(2, cfg, tp, slots=2, capacity=64, chunk_size=8,
                      paged=layout, device="cpu")
        warm.prefill_chunked(prompt, 8)
        tok_w, _ = warm.prefill_chunked(follow, 8)
        assert warm.prefix_cache.hits == 1
        # the stored entry survived the resume that wrote past it
        again, _ = warm.prefill_chunked(follow, 8)
        cold = Engine(3, cfg, tp, slots=2, capacity=64, paged=layout,
                      device="cpu")
        tok_c, _ = cold.prefill_chunked(follow, 8)
        assert tok_w == tok_c == again, f"paged={layout}"


def test_pool_pressure_reclaims_prefix_lru(weights):
    """Pool exhaustion evicts LRU prefix entries before failing; a pool
    too small even after reclaim raises BlockPoolExhausted."""
    _, cfg, _, tp = weights
    Lr = cfg.num_layers
    eng = Engine(0, cfg, tp, slots=1, capacity=64, chunk_size=8,
                 pool_blocks=1 + Lr * 3 * 3, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(4):                          # each entry: 3 blocks/layer
        eng.prefill_chunked(rng.integers(1, cfg.vocab_size, 24)
                            .astype(np.int32), 8)
    assert len(eng.prefix_cache) < 4
    tiny = Engine(1, cfg, tp, slots=1, capacity=64, chunk_size=8,
                  pool_blocks=1 + Lr, device="cpu")
    with pytest.raises(BlockPoolExhausted):
        tiny.prefill_chunked(rng.integers(1, cfg.vocab_size, 24)
                             .astype(np.int32), 8)


def test_mixed_layout_handoff_rejected(weights):
    _, cfg, _, tp = weights
    dense = Engine(0, cfg, tp, slots=2, capacity=64, paged=False,
                   device="cpu")
    paged = Engine(1, cfg, tp, slots=2, capacity=64, device="cpu")
    prompt = np.arange(1, 20, dtype=np.int32)
    _, dc = dense.prefill(prompt)
    _, pc = paged.prefill(prompt)
    assert kv_bytes(dc) == 64 * 2 * cfg.num_layers * cfg.padded_kv_heads \
        * cfg.dh * 4                            # capacity-padded
    with pytest.raises(TypeError, match="mixed-layout"):
        paged.insert(Request(rid=0, prompt=prompt, osl=2), dc)
    with pytest.raises(TypeError, match="mixed-layout"):
        dense.insert(Request(rid=1, prompt=prompt, osl=2), pc)
    assert paged.has_free_slot() and dense.has_free_slot()


# ---------------------------------------------------------------------------
# RWKV-6: disaggregated serving hands over an O(1) recurrent state

# the configuration of tests/test_serving.py::test_rwkv_family_serves
RWKV_KW = dict(name="rwkv-serve", family="ssm", block="rwkv", num_layers=2,
               d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
               vocab_size=97, remat=False, logits_chunk=32, dtype="float32")


@pytest.fixture(scope="module")
def rwkv_weights():
    jcfg, cfg = JModelConfig(**RWKV_KW), ModelConfig(**RWKV_KW)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _rwkv_requests(jax_side: bool):
    mk = (lambda: jmaterialize(JOpenLoopWorkload(
        JPoisson(100.0), JFixedShape(12, 5), vocab=97, seed=8,
        max_requests=4, horizon_s=5.0))) if jax_side else (
        lambda: materialize(OpenLoopWorkload(
            Poisson(100.0), FixedShape(12, 5), vocab=97, seed=8,
            max_requests=4, horizon_s=5.0)))
    return mk()


def test_rwkv_family_serves_matches_reference(rwkv_weights):
    """The reference's RWKV serve (1 prefill + 1 dense decode engine, 4
    slots, the state handed over): the same greedy streams on the same
    float32 weights, and the same transferred bytes — per request the
    whole state, s in fp32 plus the two shift rows."""
    jcfg, cfg, jp, tp = rwkv_weights
    jreqs, treqs = _rwkv_requests(True), _rwkv_requests(False)
    jeng = [JEngine(i, jcfg, jp, slots=4, capacity=48) for i in (0, 1)]
    jcl = JCluster({"prefill": jeng[:1], "decode": jeng[1:]})
    assert jcl.serve(JStaticWorkload(jreqs))["completed"] == 4
    teng = [Engine(i, cfg, tp, slots=4, capacity=48, device="cpu")
            for i in (0, 1)]
    assert not any(e.paged for e in teng)
    tcl = Cluster({"prefill": teng[:1], "decode": teng[1:]})
    assert tcl.serve(StaticWorkload(treqs))["completed"] == 4
    assert _streams(treqs) == _streams(jreqs)
    assert all(len(r.output) == 5 for r in treqs)
    H, N, D = cfg.num_heads, cfg.dh, cfg.d_model
    per_req = cfg.num_layers * (H * N * N * 4 + 2 * D * 4)
    assert tcl.stats.transfers == jcl.stats.transfers == 4
    assert tcl.stats.transferred_bytes == jcl.stats.transferred_bytes \
        == 4 * per_req


def test_rwkv_engine_is_dense_without_prefix_cache(rwkv_weights):
    """An RWKV engine defaults to the dense layout, refuses the paged one
    and chunked prefill (as the reference does), and builds no prefix
    cache even when given a chunk size."""
    _, cfg, _, tp = rwkv_weights
    eng = Engine(0, cfg, tp, slots=2, capacity=32, chunk_size=8,
                 device="cpu")
    assert not eng.paged and eng.prefix_cache is None
    assert set(eng.cache) == {"s", "tm_x", "cm_x", "pos"}
    assert make_engine("torch", 1, cfg, tp, device="cpu").paged is False
    with pytest.raises(ValueError, match="paged"):
        Engine(2, cfg, tp, paged=True, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.prefill_chunked(np.arange(16, dtype=np.int32), 8)
    assert eng.prefills == 0 and eng.has_free_slot()


def test_rwkv_insert_copies_the_whole_state(rwkv_weights):
    """``insert`` writes every entry of the handoff state into its slot
    (s, tm_x, cm_x), not only K/V, and leaves the other slot alone."""
    _, cfg, _, tp = rwkv_weights
    pre = Engine(0, cfg, tp, slots=1, capacity=32, device="cpu")
    dec = Engine(1, cfg, tp, slots=2, capacity=32, device="cpu")
    _, payload = pre.prefill(np.arange(1, 14, dtype=np.int32))
    before = {k: v.clone() for k, v in dec.cache.items()}
    slot = dec.insert(Request(rid=0, prompt=np.arange(13), osl=2), payload)
    for key in ("s", "tm_x", "cm_x"):
        assert float(payload[key].abs().max()) > 0.0, key
        assert torch.equal(dec.cache[key][:, slot], payload[key][:, 0]), key
        assert torch.equal(dec.cache[key][:, 1 - slot],
                           before[key][:, 1 - slot]), key
    assert int(dec.cache["pos"][slot]) == 13
    assert kv_bytes(payload) == cfg.num_layers * (
        cfg.num_heads * cfg.dh ** 2 * 4 + 2 * cfg.d_model * 4)


def test_rwkv_reused_slot_reproduces_a_fresh_stream(rwkv_weights):
    """A decode step advances every slot's state, inactive ones too; a slot
    reused after an eviction still reproduces the stream a fresh engine
    gives, because ``insert`` overwrites the whole state."""
    _, cfg, _, tp = rwkv_weights
    rng = np.random.default_rng(12)
    a, b, c = (rng.integers(0, cfg.vocab_size, 11).astype(np.int32)
               for _ in range(3))

    def stream(eng, prompt, n, others=()):
        """Prefill on a separate engine, insert, decode n tokens (with the
        ``others`` slots decoding alongside), evict."""
        tok, payload = pre.prefill(prompt)
        slot = eng.insert(Request(rid=0, prompt=prompt, osl=n), payload)
        out, toks = [tok], {slot: tok, **dict(others)}
        for _ in range(n - 1):
            toks = eng.decode_step(toks)
            out.append(toks[slot])
        eng.evict(slot)
        return out, slot

    pre = Engine(0, cfg, tp, slots=1, capacity=32, device="cpu")
    fresh, _ = stream(Engine(1, cfg, tp, slots=2, capacity=32,
                             device="cpu"), c, 6)
    eng = Engine(2, cfg, tp, slots=2, capacity=32, device="cpu")
    tok_b, pay_b = pre.prefill(b)
    slot_b = eng.insert(Request(rid=1, prompt=b, osl=9), pay_b)
    _, slot_a = stream(eng, a, 7, others={slot_b: tok_b})
    reused, slot_c = stream(eng, c, 6, others={slot_b: tok_b})
    assert slot_c == slot_a                     # the evicted slot, reused
    assert reused == fresh
