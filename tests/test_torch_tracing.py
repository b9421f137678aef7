"""The port's span tracing, Perfetto export, streaming metrics and invariant
sanitizer against the JAX package's, on the CPU.

Each is a copy of a framework-free module of the reference, driven by the
port's ``Cluster`` hooks; the comparisons are exact (``==`` on event
tuples, metric dicts and the exported JSON bytes), since both sides run
the same arithmetic on the same simulated episode. Phase tiling is held
to 1e-9 s, the bound the reference's own tests use. Every failure the
reference's sanitizer tests provoke (``tests/test_analysis.py``) must
raise in the port's copy.
"""
import json
import pathlib
import types

import numpy as np
import pytest

from repro.core.paper_models import LLAMA31_8B as J_LLAMA31_8B
from repro.serving.cluster import Cluster as JCluster
from repro.serving.metrics import QuantileSketch as JQuantileSketch
from repro.serving.metrics import StreamingMetrics as JStreamingMetrics
from repro.serving.metrics import WindowedRate as JWindowedRate
from repro.serving.obs import export_perfetto as jexport_perfetto
from repro.serving.simengine import SimEngine as JSimEngine
from repro.serving.tracing import TraceRecorder as JTraceRecorder
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import Poisson as JPoisson
from repro.workloads import TraceReplay as JTraceReplay
from repro_torch.analysis.sanitizer import (ClusterSanitizer, SanitizerError,
                                            assert_stream_parity,
                                            sanitize_enabled_by_env)
from repro_torch.core.paper_models import LLAMA31_8B
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serving.backends import init_torch_params, make_engine
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.metrics import (QuantileSketch, StreamingMetrics,
                                         WindowedRate)
from repro_torch.serving import tracing
from repro_torch.serving.obs import (export_perfetto, perfetto_trace,
                                     request_phases, validate_trace)
from repro_torch.serving.request import Request
from repro_torch.serving.simengine import SimEngine
from repro_torch.serving.tracing import (FlightRecorder, NullRecorder,
                                         TraceRecorder)
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   Poisson, TraceReplay)

TRACE_DIR = pathlib.Path(__file__).parent / "data" / "traces"
TRACES = ("burst", "diurnal", "sessions", "tiers", "fleet_diurnal")
VOCAB = 97


def _fleet(port: bool, cap: int = 128):
    """2 prefill + 2 decode sim engines of the paper's Llama-3.1-8B."""
    eng, perf = (SimEngine, LLAMA31_8B) if port else (JSimEngine,
                                                     J_LLAMA31_8B)
    return {"prefill": [eng(i, perf, slots=4, capacity=cap)
                        for i in (0, 1)],
            "decode": [eng(i, perf, slots=4, capacity=cap)
                       for i in (10, 11)]}


def _replay(port: bool, trace: str):
    cls = TraceReplay if port else JTraceReplay
    return cls(TRACE_DIR / f"{trace}.jsonl", vocab=VOCAB, seed=0)


def _traced(port: bool, trace: str):
    replay = _replay(port, trace)
    rec = (TraceRecorder if port else JTraceRecorder)()
    cl = (Cluster if port else JCluster)(
        _fleet(port, replay.max_context() + 8), recorder=rec)
    m = cl.serve(replay, max_wall_s=1e6)
    return cl, rec, m, replay


# ---------------------------------------------------------------------------
# span tracing + Perfetto export vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", TRACES)
def test_recorder_and_perfetto_match_reference(trace, tmp_path):
    """The same sim episode: the same event stream, digests, per-request
    phases, and byte-identical Perfetto JSON."""
    _, rec, m, replay = _traced(True, trace)
    _, jrec, jm, _ = _traced(False, trace)
    assert m["completed"] == len(replay.requests) > 0
    assert list(rec.events) == list(jrec.events)
    assert rec.span_digest() == jrec.span_digest()
    assert rec.span_digest(content=False) == jrec.span_digest(content=False)
    assert rec.engines == jrec.engines and rec.roles == jrec.roles
    mine, ref = tmp_path / "port.json", tmp_path / "ref.json"
    counts = export_perfetto(rec, str(mine), metrics=m)
    assert counts == jexport_perfetto(jrec, str(ref), metrics=jm)
    assert mine.read_bytes() == ref.read_bytes()
    assert validate_trace(json.loads(mine.read_text())) == counts


@pytest.mark.parametrize("trace", TRACES)
def test_phases_tile_e2e(trace):
    """queue -> prefill -> transfer -> decode tile [arrival_t, done_t] for
    every request, and the request's own attribution columns sum to its
    end-to-end latency."""
    cl, rec, m, replay = _traced(True, trace)
    phases = request_phases(rec)
    assert sorted(phases) == sorted(r.rid for r in replay.requests)
    for r in replay.requests:
        spans = phases[r.rid]
        assert abs(spans[0][1] - r.arrival_t) <= 1e-9
        assert abs(spans[-1][2] - r.done_t) <= 1e-9
        for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
            assert abs(end - start) <= 1e-9
        total = sum(t1 - t0 for _, t0, t1 in spans)
        assert abs(total - r.e2e_s) <= 1e-9
        parts = (r.queue_wait_s, r.prefill_s, r.transfer_s, r.decode_s)
        assert abs(sum(parts) - r.e2e_s) <= 1e-9, r.rid


def test_null_recorder_collapses_to_none():
    cl = Cluster(_fleet(True), recorder=NullRecorder())
    assert cl.recorder is None
    w = OpenLoopWorkload(Poisson(50.0), FixedShape(24, 6), vocab=VOCAB,
                         seed=0, max_requests=8, horizon_s=1e9)
    assert cl.serve(w, max_wall_s=1e6)["completed"] == 8
    nr = NullRecorder()
    assert nr.enabled is False and nr.events == () and nr.dumps == ()
    nr.on_arrival(None, 0.0)
    nr.on_round(None)


def test_flight_recorder_ring_and_dumps():
    fr = FlightRecorder(limit=4, max_dumps=2)
    for i in range(10):
        fr.record(("arrival", float(i), i))
    assert len(fr.snapshot()) == 4 and fr.snapshot()[0][1] == 6.0
    assert fr.dump("slo_breach", 1.0) is not None
    assert fr.dump("slo_breach", 2.0) is not None
    assert fr.dump("slo_breach", 3.0) is None
    assert fr.dropped_dumps == 1 and "arrival" in fr.format()
    # an injected engine failure dumps the ring with its span context
    rec = TraceRecorder()
    cl = Cluster(_fleet(True), recorder=rec)
    eng = cl.pools["decode"][0]
    orig, steps = eng.decode_step, [0]

    def flaky(toks):
        steps[0] += 1
        if steps[0] == 2:
            eng.fail()
        return orig(toks)
    eng.decode_step = flaky
    reqs = [Request(rid=i, prompt=np.arange(24, dtype=np.int32) + i, osl=6,
                    arrival_t=0.02 * i) for i in range(16)]
    m = cl.run(reqs, max_wall_s=1e6)
    assert m["completed"] == 16 and cl.stats.engine_failures == 1
    dumps = [d for d in rec.dumps if d["reason"] == "engine_failure"]
    assert len(dumps) == 1 and dumps[0]["events"]
    assert f"engine_id={eng.engine_id}" in dumps[0]["detail"]
    assert {"engine_failure", "requeue"} <= {ev[0] for ev in rec.events}


def test_traced_torch_serve_on_cpu():
    """The torch backend under the recorder and the sanitizer, as the card
    runs the traced serve: the sanitizer stays silent, phases tile, and
    the trace has one track per engine."""
    cfg = ModelConfig(name="sim-tiny", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=VOCAB, remat=False, logits_chunk=32,
                      dtype="float32")
    params = init_torch_params(cfg, 0, device="cpu")
    engines = [make_engine("torch", i, cfg, params, slots=4, capacity=40,
                           device="cpu") for i in (0, 1, 2)]
    rec = TraceRecorder()
    cl = Cluster({"prefill": engines[:1], "decode": engines[1:]},
                 sanitize=True, recorder=rec)
    replay = TraceReplay(TRACE_DIR / "burst.jsonl", vocab=VOCAB, seed=0)
    m = cl.serve(replay, max_wall_s=600)
    assert m["completed"] == len(replay.requests) == 10
    assert cl.sanitizer.admitted == cl.sanitizer.completed == 10
    phases = request_phases(rec)
    for r in replay.requests:
        total = sum(t1 - t0 for _, t0, t1 in phases[r.rid])
        assert abs(total - r.e2e_s) <= 1e-9
    trace = perfetto_trace(rec, metrics=m)
    validate_trace(trace)
    tracks = {(e["pid"], e["tid"]) for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert len(tracks) == 3
    assert {meta["backend"] for meta in rec.engines.values()} == {"torch"}


# ---------------------------------------------------------------------------
# streaming metrics vs the reference
# ---------------------------------------------------------------------------


def test_streaming_metrics_match_reference():
    """The same serve streamed into both packages' StreamingMetrics: the
    same result, key for key and bit for bit."""
    def run(port):
        mk = (OpenLoopWorkload, Poisson, FixedShape) if port else (
            JOpenLoopWorkload, JPoisson, JFixedShape)
        w = mk[0](mk[1](80.0), mk[2](24, 6), vocab=101, seed=17,
                  max_requests=500)
        sm = (StreamingMetrics if port else JStreamingMetrics)()
        res = (Cluster if port else JCluster)(_fleet(port)).serve(
            w, metrics=sm)
        assert res == sm.result()
        return res

    mine, ref = run(True), run(False)
    assert mine["completed"] == mine["arrived"] == 500
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_sketch_and_windowed_rate_match_reference():
    rng = np.random.default_rng(7)
    xs = rng.lognormal(-2.0, 1.2, 50_000)
    a, b = QuantileSketch(), JQuantileSketch()
    a.add_many(xs)
    b.add_many(xs)
    assert np.array_equal(a._counts, b._counts)
    assert [a.quantile(q) for q in (50, 90, 99)] == \
        [b.quantile(q) for q in (50, 90, 99)]
    ts = np.cumsum(rng.exponential(0.01, 5_000))
    wa, wb = WindowedRate(window_s=1.0), JWindowedRate(window_s=1.0)
    for t in ts:
        wa.add(float(t))
        wb.add(float(t))
    assert wa.rate() == wb.rate() > 0
    assert wa.totals() == wb.totals()
    assert wa.total == ts.size


# ---------------------------------------------------------------------------
# the invariant sanitizer
# ---------------------------------------------------------------------------


def _sim_cluster(engine_cls=SimEngine, **kw):
    mk = lambda i: engine_cls(i, LLAMA31_8B, slots=4, capacity=96)  # noqa
    return Cluster({"prefill": [mk(0)], "decode": [mk(1), mk(2)]}, **kw)


def _workload(n=6):
    return OpenLoopWorkload(Burst(n, at=0.0), FixedShape(16, 4), vocab=97,
                            seed=0)


def test_sanitizer_clean_run_and_parity_with_reference():
    a, b = _sim_cluster(sanitize=True), _sim_cluster(sanitize=True)
    ma = a.serve(_workload())
    b.serve(_workload())
    assert ma["completed"] == 6
    assert a.sanitizer.admitted == a.sanitizer.completed == 6
    assert_stream_parity(a.sanitizer, b.sanitizer)
    assert_stream_parity(a.sanitizer, b.sanitizer, content=False)
    # the reference's sanitizer hashes the same streams
    jcl = JCluster({"prefill": [JSimEngine(0, J_LLAMA31_8B, slots=4,
                                           capacity=96)],
                    "decode": [JSimEngine(i, J_LLAMA31_8B, slots=4,
                                          capacity=96) for i in (1, 2)]},
                   sanitize=True)
    jcl.serve(JOpenLoopWorkload(JBurst(6, at=0.0), JFixedShape(16, 4),
                                vocab=97, seed=0))
    assert a.sanitizer.token_hashes() == jcl.sanitizer.token_hashes()


def test_sanitizer_off_by_default_and_env_enabled(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize_enabled_by_env()
    assert _sim_cluster().sanitizer is None
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert _sim_cluster().sanitizer is not None
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert _sim_cluster().sanitizer is None
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert _sim_cluster(sanitize=False).sanitizer is None   # flag wins


class _BackwardsClockEngine(SimEngine):
    """An engine whose steps rewind virtual time."""

    def _advance(self, dt):
        return super()._advance(-abs(dt))


class _MutatingScheduler:
    """Impure: edits cluster state inside select."""

    def select(self, cluster, engine):
        cluster.now += 1e-6
        return None

    def run_prefill(self, cluster, engine, req):       # pragma: no cover
        raise AssertionError("select never admits")


class _MutatingRouter:
    def route(self, cluster, req, src):
        cluster.queue.push_front(req)       # laundered requeue
        return src


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def provoke_time_regression():
    cl = _sim_cluster(_BackwardsClockEngine, sanitize=True)
    cl.serve(_workload())


def provoke_decode_before_insert():
    san, req = ClusterSanitizer(), _ns(rid=7, output=[])
    san.on_arrival(req, 0.0)
    san.on_token(req, _ns(engine_id=0), 0.1)


def provoke_double_prefill_per_round():
    san, eng = ClusterSanitizer(), _ns(engine_id=0)
    r1, r2 = _ns(rid=1, output=[]), _ns(rid=2, output=[])
    san.on_round(0.0)
    for r in (r1, r2):
        san.on_arrival(r, 0.0)
    san.on_prefill(r1, eng, 0.1)
    san.on_prefill(r2, eng, 0.2)


def provoke_conservation_loss():
    san, req = ClusterSanitizer(), _ns(rid=3, output=[])
    san.on_arrival(req, 0.0)
    san.on_episode_end(_ns(queue=[], pending_insert=[], engines=lambda: []),
                       [req])


def provoke_requeue_after_completion():
    san, eng = ClusterSanitizer(), _ns(engine_id=0)
    req = _ns(rid=4, output=[1, 2])
    san.on_arrival(req, 0.0)
    san.on_prefill(req, eng, 0.1)
    san.on_insert(req, eng, 0.1)
    san.on_complete(req, 0.2)
    san.on_requeue(req)


def provoke_stream_divergence():
    a, b = ClusterSanitizer(), ClusterSanitizer()
    eng = _ns(engine_id=0)
    for san, toks in ((a, [1, 2, 3]), (b, [1, 2, 4])):
        req = _ns(rid=1, output=toks)
        san.on_arrival(req, 0.0)
        san.on_prefill(req, eng, 0.1)
        san.on_insert(req, eng, 0.1)
        san.on_complete(req, 0.2)
    assert_stream_parity(a, b, content=False)   # same lengths pass
    assert_stream_parity(a, b)


def provoke_impure_scheduler():
    _sim_cluster(sanitize=True, scheduler=_MutatingScheduler()).serve(
        _workload(2), max_wall_s=5)


def provoke_impure_router():
    _sim_cluster(sanitize=True, router=_MutatingRouter()).serve(
        _workload(2), max_wall_s=5)


def provoke_ghost_completion_with_flight_ring():
    rec = TraceRecorder()
    cl = _sim_cluster(sanitize=True, recorder=rec)
    assert cl.sanitizer.flight is rec.flight
    assert cl.serve(_workload(4))["completed"] == 4
    ghost = Request(rid=999, prompt=np.arange(4, dtype=np.int32), osl=1)
    try:
        cl.sanitizer.on_complete(ghost, cl.now)
    finally:
        assert [d["reason"] for d in rec.dumps] == ["sanitizer_error"]


PROVOKED = {
    "time_regression": (provoke_time_regression, "ran backwards"),
    "decode_before_insert": (provoke_decode_before_insert,
                             "decoded before insert"),
    "double_prefill_per_round": (provoke_double_prefill_per_round,
                                 "2 prefills"),
    "conservation_loss": (provoke_conservation_loss, "conservation"),
    "requeue_after_completion": (provoke_requeue_after_completion,
                                 "requeued after completion"),
    "stream_divergence": (provoke_stream_divergence, "diverged"),
    "hook_purity_scheduler": (provoke_impure_scheduler,
                              "scheduler.select mutated"),
    "hook_purity_router": (provoke_impure_router, "router.route mutated"),
    "flight_ring_on_error": (provoke_ghost_completion_with_flight_ring,
                             "flight recorder"),
}


@pytest.mark.parametrize("case", sorted(PROVOKED))
def test_sanitizer_raises(case):
    fn, match = PROVOKED[case]
    with pytest.raises(SanitizerError, match=match):
        fn()


def test_sanitizer_quiet_for_stock_policies_and_engine_failure():
    """Stock policies pass the purity guard, and a mid-serve engine failure
    is a tracked replay, not a violation."""
    assert _sim_cluster(sanitize=True).serve(_workload(4))["completed"] == 4
    cl = _sim_cluster(sanitize=True)
    bad = cl.decode_pool[0]
    orig, fired = bad.decode_step, [False]

    def flaky(toks):
        if len(bad.step_times) >= 2 and not fired[0]:
            fired[0] = True
            bad.fail()
        return orig(toks)
    bad.decode_step = flaky
    assert cl.serve(_workload(6), max_wall_s=600)["completed"] == 6
    assert cl.sanitizer.engine_failures == 1
    assert cl.sanitizer.requeued == cl.stats.requeued >= 1


# ---------------------------------------------------------------------------
# spans on the profiler's clock (serving.tracing.span)
# ---------------------------------------------------------------------------

SPAN_LAYERS = 2
SPAN_CFGS = {
    "dense": ModelConfig(name="span-dense", family="dense",
                         num_layers=SPAN_LAYERS, d_model=64, num_heads=4,
                         num_kv_heads=2, d_ff=128, vocab_size=VOCAB,
                         remat=False, dtype="float32"),
    "moe": ModelConfig(name="span-moe", family="moe", num_layers=SPAN_LAYERS,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=32,
                       vocab_size=VOCAB, remat=False, dtype="float32",
                       moe=MoEConfig(num_experts=4, top_k=2,
                                     d_ff_expert=32, capacity_factor=2.0)),
}
MOE_PHASES = ("repro_torch.moe.route", "repro_torch.moe.dispatch",
              "repro_torch.moe.experts", "repro_torch.moe.combine")
# each span's enclosing span (None: outermost)
SPAN_PARENTS = {
    "repro_torch.engine.prefill": {None},
    "repro_torch.engine.prefill.payload": {"repro_torch.engine.prefill"},
    "repro_torch.engine.prefill.readback": {"repro_torch.engine.prefill"},
    "repro_torch.engine.insert": {None},
    "repro_torch.engine.decode": {None},
    "repro_torch.engine.decode.prepare": {"repro_torch.engine.decode"},
    "repro_torch.engine.decode.readback": {"repro_torch.engine.decode"},
    "repro_torch.model.mixer": {"repro_torch.engine.prefill",
                                "repro_torch.engine.decode"},
    "repro_torch.model.ffn": {"repro_torch.engine.prefill",
                              "repro_torch.engine.decode"},
    "repro_torch.model.moe": {"repro_torch.engine.prefill",
                              "repro_torch.engine.decode"},
    "repro_torch.model.logits": {"repro_torch.engine.prefill",
                                 "repro_torch.engine.decode"},
    **{name: {"repro_torch.model.moe"} for name in MOE_PHASES},
}


def _span_engines(kind):
    cfg = SPAN_CFGS[kind]
    params = init_torch_params(cfg, 0, device="cpu")
    return [make_engine("torch", i, cfg, params, slots=4, capacity=48,
                        device="cpu") for i in (0, 1)]


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: the program's spans as
    (name, start ns, end ns), and every name the profile holds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return ([e for e in events if e[0].startswith("repro_torch")],
            {e[0] for e in events})


def _parent(sp, spans):
    """The innermost other span that holds ``sp``, or None."""
    around = [o for o in spans if o is not sp and o[1] <= sp[1]
              and sp[2] <= o[2] and (o[2] - o[1]) >= (sp[2] - sp[1])]
    return min(around, key=lambda o: o[2] - o[1])[0] if around else None


def _step_spans(kind, step):
    """The spans one step of ``step`` records, by name."""
    from collections import Counter
    L = SPAN_LAYERS
    ffn = "repro_torch.model.moe" if kind == "moe" else "repro_torch.model.ffn"
    model = {"repro_torch.model.mixer": L, ffn: L,
             "repro_torch.model.logits": 1}
    if kind == "moe":
        model.update({name: L for name in MOE_PHASES})
    want = {"prefill": {"repro_torch.engine.prefill": 1,
                        "repro_torch.engine.prefill.payload": 1,
                        "repro_torch.engine.prefill.readback": 1, **model},
            "insert": {"repro_torch.engine.insert": 1},
            "decode": {"repro_torch.engine.decode": 1,
                       "repro_torch.engine.decode.prepare": 1,
                       "repro_torch.engine.decode.readback": 1, **model}}
    return Counter(want[step])


@pytest.mark.parametrize("kind", sorted(SPAN_CFGS))
def test_engine_and_model_spans_under_the_profiler(kind):
    """One prefill, insert and paged decode step of a dense and of a MoE
    engine under a CPU profiler record exactly the spans of each site,
    nested as the engine and the model nest them, named under
    ``repro_torch.`` with no kernel-name fragment; the steps' results are
    those of the same steps unprofiled."""
    from collections import Counter
    prompt = (np.arange(20, dtype=np.int32) * 7) % VOCAB
    results = []
    for profiled in (False, True):
        pre, dec = _span_engines(kind)
        box = {}

        def prefill():
            box["tok"], box["payload"] = pre.prefill(prompt)

        def insert():
            box["slot"] = dec.insert(types.SimpleNamespace(), box["payload"])

        def decode():
            box["next"] = dec.decode_step({box["slot"]: box["tok"]})
        for step, fn in (("prefill", prefill), ("insert", insert),
                         ("decode", decode)):
            if not profiled:
                fn()
                continue
            spans, _ = _profiled(fn)
            assert Counter(n for n, _, _ in spans) == _step_spans(kind,
                                                                  step), step
            for sp in spans:
                assert sp[0].startswith("repro_torch.")
                assert "_kernel" not in sp[0]
                assert _parent(sp, spans) in SPAN_PARENTS[sp[0]], sp
        results.append((box["tok"], box["next"]))
    assert results[0] == results[1]


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler running a decode step opens no range: the
    profiler's range is never constructed, and every span is the one
    shared no-op context."""
    pre, dec = _span_engines("moe")
    slot = dec.insert(types.SimpleNamespace(),
                      pre.prefill(np.arange(12, dtype=np.int32))[1])
    tracing.span("repro_torch.test")        # binds the profiler
    made = []
    real = tracing._range

    def counted(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(tracing, "_range", counted)
    dec.decode_step({slot: 3})
    assert made == []
    assert tracing.span("repro_torch.test") is tracing.span("repro_torch.x")
    spans, _ = _profiled(lambda: dec.decode_step({slot: 4}))
    assert len(made) == len(spans) > 0      # the counter sees the ranges
