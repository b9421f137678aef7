"""The port's analytic-time simulator (``repro_torch.serving.simengine``)
against the JAX package's, on the CPU.

Both simulators are numpy only and do the same float64 arithmetic in the
same order, so on the same trace, fleet, chip, policies and calibration
the port's ``SimEngine`` + ``Cluster`` give the reference's
``sla_metrics`` and per-request token streams exactly — compared with
``==`` (NaN equal to NaN), no tolerance — at full width (qwen2.5-3b,
rwkv6-1.6b) as on the smoke configurations. Then the reference's own
sim cases run on the port, the pinned token-stream digest among them;
``make_engine`` dispatches; ``calibrate`` fits through the port's torch
``Engine`` on the CPU; and the torch backend and the port's sim serve
the trace corpus to the same per-request token counts.

Nothing here times the wall clock: the fitted scales' values and the
sim-to-real latency ratios are checked on the card by ``chip_smoke.py``.
"""
import dataclasses
import hashlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.hardware import get_chip as jget_chip
from repro.serving import policies as JP
from repro.serving.cluster import Cluster as JCluster
from repro.serving.simengine import SimCalibration as JSimCalibration
from repro.serving.simengine import SimEngine as JSimEngine
from repro.workloads import TraceReplay as JTraceReplay
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.hardware import (TPU_V5E, TPU_V5P, get_chip,
                                       relative_speed)
from repro_torch.core.paper_models import LLAMA31_8B
from repro_torch.models.config import ModelConfig
from repro_torch.serving import policies as P
from repro_torch.serving.backends import (BACKENDS, init_torch_params,
                                          make_engine)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.common import EngineFailure
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request
from repro_torch.serving.simengine import (SimCalibration, SimEngine,
                                           _token_base, calibrate,
                                           load_calibration,
                                           save_calibration)
from repro_torch.workloads import (FixedShape, OpenLoopWorkload, Poisson,
                                   Recorder, TraceReplay)

TRACE_DIR = pathlib.Path(__file__).parent / "data" / "traces"
TRACES = ("burst", "diurnal", "sessions", "tiers")
VOCAB = 97

# the trace-corpus model of the reference's sim tests
CFG = ModelConfig(name="sim-tiny", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=VOCAB,
                  remat=False, logits_chunk=32, dtype="float32")
# a fit of the order the card gives (scales of tens): the same on both
# sides, so parity covers the calibrated clock
CAL = (11.5, 29.25)


# ---------------------------------------------------------------------------
# parity with the reference: every corpus trace, full width and smoke
# ---------------------------------------------------------------------------

# (name, pools, cluster policies, engine keywords) per policy stack; the
# policy module is the side's own (repro.serving.policies or the port's)
STACKS = {
    "fcfs": lambda p: ({"prefill": 1, "decode": 2},
                       dict(scheduler=p.FCFSScheduler(),
                            router=p.RoundRobinRouter()), {}),
    "elastic-paged": lambda p: ({"prefill": 1, "decode": 2},
                                dict(scheduler=p.PriorityScheduler(),
                                     router=p.LeastLoadedRouter(),
                                     rate_matcher=p.ElasticPolicy()),
                                {"block_size": 8}),
    "coloc-prefix": lambda p: ({"mixed": 2},
                               dict(scheduler=p.ChunkedPiggybackScheduler(8),
                                    router=p.KVLocalityRouter()),
                               {"chunk_size": 8}),
}
PARITY_CASES = [
    (trace, arch, size, chip, stack)
    for trace in TRACES
    for arch in ("qwen2.5-3b", "rwkv6-1.6b")
    for size in ("full", "smoke")
    for chip in ("h100", "v5e")
    for stack in STACKS
    # RWKV prompts are never chunked: no co-located RWKV deployment
    if not (arch == "rwkv6-1.6b" and stack == "coloc-prefix")
]


def _serve_sim(port: bool, trace, arch, size, chip, stack):
    if port:
        cfg = (get_config if size == "full" else get_smoke_config)(arch)
        mods = (P, Cluster, SimEngine, SimCalibration, TraceReplay, get_chip)
    else:
        cfg = (jget_config if size == "full" else jget_smoke_config)(arch)
        mods = (JP, JCluster, JSimEngine, JSimCalibration, JTraceReplay,
                jget_chip)
    pol, cluster_cls, sim_cls, cal_cls, replay_cls, chip_of = mods
    replay = replay_cls(TRACE_DIR / f"{trace}.jsonl", vocab=cfg.vocab_size,
                        seed=0)
    pools, policies, kw = STACKS[stack](pol)
    cap = replay.max_context() + 8 + kw.get("chunk_size", 0)
    ids = iter(range(100))
    cl = cluster_cls(
        {role: [sim_cls(next(ids), cfg, slots=4, capacity=cap,
                        chip=chip_of(chip), calibration=cal_cls(*CAL), **kw)
                for _ in range(n)] for role, n in pools.items()},
        **policies)
    metrics = cl.serve(replay, max_wall_s=1e6)
    streams = {r.rid: list(r.output) for r in replay.requests}
    return metrics, streams, dataclasses.asdict(cl.stats), cl.now


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN (a metric with no samples is NaN)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


@pytest.mark.parametrize("trace,arch,size,chip,stack", PARITY_CASES)
def test_sim_cluster_matches_reference_on_corpus(trace, arch, size, chip,
                                                 stack):
    """Same trace, fleet, chip, policies and calibration: the same SLA
    metrics, token streams, transfer counts and bytes, and final virtual
    clock, bit for bit."""
    m_t, s_t, st_t, now_t = _serve_sim(True, trace, arch, size, chip, stack)
    m_j, s_j, st_j, now_j = _serve_sim(False, trace, arch, size, chip, stack)
    assert m_t["completed"] == len(s_t) > 0
    assert all(len(out) > 0 for out in s_t.values())
    assert sorted(m_t) == sorted(m_j)
    bad = {k: (m_t[k], m_j[k]) for k in m_t if not _same(m_t[k], m_j[k])}
    assert not bad, bad
    assert s_t == s_j
    assert st_t == st_j and now_t == now_j


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_sim_cluster_matches_reference_for_granite(size):
    """granite-moe-1b-a400m (the MoE family; the perf model prices its
    experts) on every corpus trace and policy stack, h100: the same
    metrics, streams, transfers and clock as the reference, bit for bit."""
    for trace in TRACES:
        for stack in STACKS:
            case = (trace, "granite-moe-1b-a400m", size, "h100", stack)
            m_t, s_t, st_t, now_t = _serve_sim(True, *case)
            m_j, s_j, st_j, now_j = _serve_sim(False, *case)
            assert m_t["completed"] == len(s_t) > 0, case
            bad = {k: (m_t[k], m_j[k]) for k in m_t
                   if not _same(m_t[k], m_j[k])}
            assert not bad and sorted(m_t) == sorted(m_j), (case, bad)
            assert s_t == s_j and st_t == st_j and now_t == now_j, case


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ["musicgen-large", "mistral-large-123b",
                                  "llava-next-34b", "kimi-k2-1t-a32b"])
def test_sim_cluster_matches_reference_for_the_new_ids(arch, size):
    """The registry's four newest ids (the sim prices all ten, whatever
    the torch backend serves) on every corpus trace and policy stack,
    h100: the same metrics, streams, transfers and clock as the
    reference, bit for bit."""
    for trace in TRACES:
        for stack in STACKS:
            case = (trace, arch, size, "h100", stack)
            m_t, s_t, st_t, now_t = _serve_sim(True, *case)
            m_j, s_j, st_j, now_j = _serve_sim(False, *case)
            assert m_t["completed"] == len(s_t) > 0, case
            bad = {k: (m_t[k], m_j[k]) for k in m_t
                   if not _same(m_t[k], m_j[k])}
            assert not bad and sorted(m_t) == sorted(m_j), (case, bad)
            assert s_t == s_j and st_t == st_j and now_t == now_j, case


def test_perf_llm_bridge_matches_reference():
    """Both served families map to the reference's analytic model field for
    field, at full width: qwen to GQA, RWKV-6 to attention-free."""
    from repro.core.paper_models import perf_llm_from_config as jbridge
    from repro_torch.core.paper_models import perf_llm_from_config
    for arch, attention in (("qwen2.5-3b", "gqa"), ("rwkv6-1.6b", "none"),
                            ("granite-moe-1b-a400m", "gqa")):
        mine = perf_llm_from_config(get_config(arch))
        ref = jbridge(jget_config(arch))
        assert mine.attention == attention
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# the reference's sim cases (tests/test_simengine.py), run on the port
# ---------------------------------------------------------------------------


def sim(i, slots=4, capacity=64, chunk_size=0, chip=None, cfg=CFG, **kw):
    return SimEngine(i, cfg, slots=slots, capacity=capacity,
                     chunk_size=chunk_size, chip=chip, **kw)


def gen_workload(n=8, seed=0, isl=16, osl=6, rate=100.0, vocab=VOCAB):
    return OpenLoopWorkload(Poisson(rate), FixedShape(isl, osl),
                            vocab=vocab, seed=seed, max_requests=n,
                            horizon_s=100.0)


def _sim_cluster(base_id=0, chip=None, **cluster_kw):
    return Cluster({"prefill": [sim(base_id, chip=chip)],
                    "decode": [sim(base_id + 1, chip=chip),
                               sim(base_id + 2, chip=chip)]},
                   **cluster_kw)


def case_bookkeeping_only():
    eng = sim(0)
    prompt = np.random.default_rng(0).integers(0, VOCAB, 16).astype(np.int32)
    tok, cache = eng.prefill(prompt)
    assert 0 <= tok < VOCAB
    assert cache.length == 16 and cache.nbytes > 0
    assert len(eng.step_times) == 1 and eng.step_times[0] > 0
    req = Request(rid=0, prompt=prompt, osl=4)
    req.output.append(tok)
    slot = eng.insert(req, cache)
    assert req.slot == slot and eng.active == 1
    nxt = eng.decode_step({slot: tok})
    assert set(nxt) == {slot} and 0 <= nxt[slot] < VOCAB
    assert len(eng.step_times) == 2
    eng.evict(slot)
    assert eng.active == 0 and eng.has_free_slot()


def case_per_request_determinism():
    """Same prompt -> same stream, on any engine and chip."""
    prompt = np.random.default_rng(1).integers(0, VOCAB, 12).astype(np.int32)

    def stream(eng, n=6):
        tok, cache = eng.prefill(prompt)
        req = Request(rid=0, prompt=prompt, osl=n)
        req.output.append(tok)
        s = eng.insert(req, cache)
        out = [tok]
        for _ in range(n - 1):
            tok = eng.decode_step({s: tok})[s]
            out.append(tok)
        return out

    a = stream(sim(0))
    assert a == stream(sim(1, chip=TPU_V5P))
    other = (prompt + 1) % VOCAB
    tok_other, _ = sim(2).prefill(other)
    assert tok_other != a[0] or _token_base(prompt) != _token_base(other)


def case_chunked_matches_full_and_reuses_prefix():
    eng = sim(0, chunk_size=8, capacity=64)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, VOCAB, 24).astype(np.int32)
    p1 = np.concatenate([shared, rng.integers(0, VOCAB, 8).astype(np.int32)])
    p2 = np.concatenate([shared, rng.integers(0, VOCAB, 8).astype(np.int32)])
    t_full, _ = sim(9).prefill(p1)
    t1, _ = eng.prefill_chunked(p1, 8)
    assert t1 == t_full
    cold = eng.step_times[-1]
    eng.prefill_chunked(p2, 8)
    warm = eng.step_times[-1]
    assert eng.prefix_cache.hits == 1
    assert eng.prefix_cache.hit_tokens == 24
    assert warm < cold
    chunks = []
    eng.prefill_chunked(p2, 8, on_chunk=lambda i, n: chunks.append((i, n)))
    assert chunks and chunks[-1][1] == len(chunks)


def case_roofline_scales_with_work_and_chip():
    eng = sim(0, capacity=600)
    assert eng._prefill_s(512) > eng._prefill_s(64) > 0
    assert eng._decode_s(8, 256) > eng._decode_s(1, 256) > 0
    assert eng._decode_s(4, 512) > eng._decode_s(4, 32)
    fast, slow = sim(1, chip=TPU_V5P), sim(2, chip=TPU_V5E)
    assert fast._prefill_s(256) < slow._prefill_s(256)
    assert fast._decode_s(4, 128) < slow._decode_s(4, 128)
    assert fast.capacity_weight == pytest.approx(relative_speed(TPU_V5P))
    # the card the port runs on is modelled faster than either TPU
    h100 = sim(3, chip=get_chip("h100"))
    assert h100._prefill_s(256) < fast._prefill_s(256)


def case_stragglers_and_failures():
    eng = sim(0)
    prompt = np.arange(8, dtype=np.int32)
    eng.prefill(prompt)
    base = eng.step_times[-1]
    eng.slow_down(10.0)
    eng.prefill(prompt)
    assert eng.step_times[-1] == pytest.approx(10.0 * base)
    eng.fail()
    with pytest.raises(EngineFailure):
        eng.prefill(prompt)


def case_calibration_scales_virtual_time():
    cal = SimCalibration(prefill_scale=100.0, decode_scale=7.0)
    raw, scaled = sim(0), sim(1, calibration=cal)
    assert scaled._prefill_s(64) == pytest.approx(100.0 * raw._prefill_s(64))
    assert scaled._decode_s(2, 64) == pytest.approx(7.0 * raw._decode_s(2, 64))


def case_accepts_perf_llm_models():
    eng = SimEngine(0, LLAMA31_8B, slots=4, capacity=300,
                    chip=get_chip("v5p"))
    prompt = np.arange(64, dtype=np.int32) % LLAMA31_8B.vocab_size
    tok, cache = eng.prefill(prompt)
    assert 0 <= tok < LLAMA31_8B.vocab_size
    assert 1e-4 < eng.step_times[-1] < 10.0
    assert cache.nbytes == int(300 * LLAMA31_8B.kv_bytes_per_token())


def _episode(seed=3):
    cl = _sim_cluster()
    work = Recorder(gen_workload(n=12, seed=seed, isl=16, osl=6))
    metrics = cl.serve(work, max_wall_s=1e6)
    return metrics, sorted(work.emitted, key=lambda r: r.rid)


def case_determinism_golden():
    """The reference's pinned digest of the episode's token streams
    (tests/test_simengine.py): the port's counting rng is the same
    contract."""
    m1, e1 = _episode()
    m2, e2 = _episode()
    assert m1 == m2
    streams = [(r.rid, tuple(r.output)) for r in e1]
    assert streams == [(r.rid, tuple(r.output)) for r in e2]
    digest = hashlib.sha256(
        json.dumps(streams, sort_keys=True).encode()).hexdigest()
    assert digest == ("8c0e322c6623f080423c59f5b74deb60"
                      "654cb02a320bbeed46cbe9e9e53e9087")


def case_failure_requeue_replays_identically():
    work_ref = Recorder(gen_workload(n=8, seed=4, osl=6))
    m_ref = _sim_cluster().serve(work_ref, max_wall_s=1e6)
    work = Recorder(gen_workload(n=8, seed=4, osl=6))
    cl = _sim_cluster(base_id=10, rate_matcher=P.ElasticPolicy())
    bad = cl.decode_pool[0]
    orig = bad.decode_step
    fired = [False]

    def flaky(toks):
        if len(bad.step_times) >= 2 and not fired[0]:
            fired[0] = True
            bad.fail()
        return orig(toks)
    bad.decode_step = flaky
    m = cl.serve(work, max_wall_s=1e6)
    assert m["completed"] == m_ref["completed"] == 8
    assert cl.stats.engine_failures == 1 and cl.stats.requeued >= 1
    ref = {r.rid: list(r.output) for r in work_ref.emitted}
    for r in work.emitted:
        assert r.output == ref[r.rid], r.rid


def case_heterogeneous_pools():
    cl = Cluster({"prefill": [sim(0, chip=get_chip("h100"))],
                  "decode": [sim(1, chip=get_chip("v5e")), sim(2)]},
                 scheduler=P.PriorityScheduler(),
                 rate_matcher=P.ElasticPolicy())
    m = cl.serve(gen_workload(n=16, seed=5, rate=1e6), max_wall_s=1e6)
    assert m["completed"] == 16
    assert cl.pool_hardware()["prefill"] == {"gpu-h100": 1}
    assert cl.stats.transferred_bytes > 0


SIM_CASES = {f.__name__[len("case_"):]: f for f in (
    case_bookkeeping_only, case_per_request_determinism,
    case_chunked_matches_full_and_reuses_prefix,
    case_roofline_scales_with_work_and_chip, case_stragglers_and_failures,
    case_calibration_scales_virtual_time, case_accepts_perf_llm_models,
    case_determinism_golden, case_failure_requeue_replays_identically,
    case_heterogeneous_pools)}


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_reference_sim_case_on_port(name):
    SIM_CASES[name]()


# ---------------------------------------------------------------------------
# make_engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    return init_torch_params(CFG, 0, device="cpu")


@pytest.mark.parametrize("backend", ("sim", "torch", "other"))
def test_make_engine_backends(backend, tiny_params):
    assert BACKENDS == ("torch", "sim")
    if backend == "sim":
        # torch-only knobs are dropped; no params needed
        e = make_engine("sim", 7, CFG, slots=2, capacity=32,
                        chip=get_chip("h100"), paged=True, pool_blocks=9,
                        device="cuda", calibration=SimCalibration(2.0, 2.0))
        assert isinstance(e, SimEngine) and e.backend == "sim"
        assert e.engine_id == 7 and e.hardware == "gpu-h100"
        assert e.calibration == SimCalibration(2.0, 2.0)
    elif backend == "torch":
        e = make_engine("torch", 3, CFG, tiny_params, slots=2, capacity=32,
                        device="cpu", calibration=SimCalibration())
        assert isinstance(e, Engine) and e.backend == "torch"
        with pytest.raises(ValueError, match="params"):
            make_engine("torch", 0, CFG)
    else:
        with pytest.raises(ValueError, match="unknown backend"):
            make_engine(backend, 0, CFG)


# ---------------------------------------------------------------------------
# calibrate through the port's torch Engine (on the CPU here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("qwen2.5-3b", "rwkv6-1.6b"))
def test_calibrate_fits_and_persists_on_cpu(arch, tmp_path):
    cfg = get_smoke_config(arch)
    path = str(tmp_path / "cal.json")
    h100 = get_chip("h100")
    cal = calibrate(cfg, chip=h100, isl=24, osl=6, batch=2, n_prompts=3,
                    path=path, device="cpu")
    assert cal.prefill_scale > 0 and cal.decode_scale > 0
    assert math.isfinite(cal.prefill_scale) and math.isfinite(
        cal.decode_scale)
    assert load_calibration(path, cfg.name, h100) == cal
    rec = json.loads(pathlib.Path(path).read_text())[f"{cfg.name}/gpu-h100"]
    # first prefill and first decode step dropped from the fit; the
    # steps run are recorded beside it
    assert rec["prefills"] == 4 and rec["decode_steps"] == 6
    assert rec["device"] == "cpu"
    assert rec["prefill_scale"] == pytest.approx(
        rec["measured_prefill_s"] / rec["predicted_prefill_s"])
    assert rec["decode_scale"] == pytest.approx(
        rec["measured_decode_s"] / rec["predicted_decode_s"])
    # other chips miss cleanly; saving another chip merges, not clobbers
    assert load_calibration(path, cfg.name, TPU_V5P) is None
    assert load_calibration(path, cfg.name, None) is None
    assert load_calibration(str(tmp_path / "absent.json"), cfg.name,
                            h100) is None
    save_calibration(path, cfg.name, TPU_V5P, SimCalibration(3.0, 4.0))
    assert load_calibration(path, cfg.name, TPU_V5P) == \
        SimCalibration(3.0, 4.0)
    assert load_calibration(path, cfg.name, h100) == cal


def test_calibrate_defaults_to_the_card(monkeypatch):
    """No device named and no card: raise, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate(get_smoke_config("qwen2.5-3b"), isl=8, osl=2)


# ---------------------------------------------------------------------------
# torch backend vs the port's sim on the corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", TRACES)
def test_torch_backend_and_sim_serve_corpus_alike(trace, tiny_params):
    """The same trace and policies on both of the port's backends: every
    request completes, with the same token count per request and the same
    number of handoffs."""
    def run(backend):
        replay = TraceReplay(TRACE_DIR / f"{trace}.jsonl", vocab=VOCAB,
                             seed=0)
        cap = replay.max_context() + 8
        kw = {"device": "cpu"} if backend == "torch" else {}
        cl = Cluster({"prefill": [make_engine(backend, 0, CFG, tiny_params,
                                              slots=4, capacity=cap, **kw)],
                      "decode": [make_engine(backend, i, CFG, tiny_params,
                                             slots=4, capacity=cap, **kw)
                                 for i in (1, 2)]},
                     scheduler=P.FCFSScheduler(),
                     router=P.RoundRobinRouter())
        m = cl.serve(replay, max_wall_s=600)
        return m, {r.rid: len(r.output) for r in replay.requests}, cl

    m_t, n_t, cl_t = run("torch")
    m_s, n_s, cl_s = run("sim")
    assert m_t["completed"] == m_s["completed"] == len(n_t) > 0
    assert n_t == n_s
    assert cl_t.stats.transfers == cl_s.stats.transfers == len(n_t)
