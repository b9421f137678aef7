"""What the paged decode step's CUDA graphs (``serving/graphs.py``) rest
on, checked without a card: the window that keys a graph, the staging of a
step's inputs into fixed buffers (equal to the tensors the step took
before it), the eager path wherever there is no card, and the replay's
bookkeeping (inputs copied in when they are not the capture's own, moved
tensors refused, launch counts advanced). The graphs themselves run on
the card: ``tests/test_torch_decode_graph_gpu.py``."""
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serving.backends import init_torch_params, make_engine
from repro_torch.serving.engine import window_blocks
from repro_torch.serving.graphs import DecodeGraphs, _Graph, graph_key


def _cfg(moe: bool = False) -> ModelConfig:
    return ModelConfig(name="graph-cpu", family="moe" if moe else "dense",
                       num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=96, remat=False, dtype="float32",
                       moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                                     capacity_factor=2.0) if moe else None)


def _engines(cfg, slots: int = 4, capacity: int = 96):
    params = init_torch_params(cfg, 0, device="cpu")
    return [make_engine("torch", i, cfg, params, slots=slots,
                        capacity=capacity, device="cpu") for i in (0, 1)]


@pytest.mark.parametrize("max_pos,nb", [
    (0, 1), (7, 1), (8, 2), (15, 2), (16, 4), (31, 4), (32, 8), (63, 8),
    (64, 12), (95, 12), (1000, 12)])
def test_window_blocks(max_pos, nb):
    """The least power of two of 8-token blocks that holds ``max_pos``,
    capped at the table's 12 blocks."""
    assert window_blocks(max_pos, 8, 12) == nb


def test_window_is_the_graph_key():
    """One key a window: the staged inputs of two steps in the same window
    share it (and their tensors), another window has its own; at most
    log2 of the table's width plus one keys an engine."""
    _, dec = _engines(_cfg())
    a = dec._stage({0: 5}, 4)
    b = dec._stage({1: 7, 2: 3}, 4)
    c = dec._stage({0: 5}, 8)
    assert graph_key(a) == graph_key(b) != graph_key(c)
    assert [t.data_ptr() for t in a] == [t.data_ptr() for t in b]
    keys = {graph_key(dec._stage({}, window_blocks(p, 8, dec._nb_max)))
            for p in range(dec.capacity)}
    assert len(keys) == 5 == int(np.ceil(np.log2(dec._nb_max))) + 1


@pytest.mark.parametrize("nb", [1, 4, 12])
def test_staging_equals_the_uploaded_inputs(nb):
    """The staged (tables, pos, tokens) equal, in value, dtype and shape,
    the tensors the step was given before staging: the table window made
    contiguous, the positions and the step's tokens, each uploaded on its
    own."""
    pre, dec = _engines(_cfg())
    rng = np.random.default_rng(3)
    slots = []
    for n in (13, 40, 5):
        _, payload = pre.prefill(rng.integers(0, 96, n).astype(np.int32))
        slots.append(dec.insert(types.SimpleNamespace(), payload))
    dec.evict(slots[1])
    step = {slots[0]: 17, slots[2]: 90}
    tables, pos, toks = dec._stage(step, nb)
    want = (torch.as_tensor(np.ascontiguousarray(dec._tables[:, :, :nb])),
            torch.as_tensor(dec._pos), dec._step_tokens(step))
    for got, ref in zip((tables, pos, toks), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)
    assert tables.is_contiguous()
    # a later step with fewer rows leaves nothing of this one behind
    _, _, toks = dec._stage({slots[2]: 1}, nb)
    assert torch.equal(toks, dec._step_tokens({slots[2]: 1}))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_graphs_on_the_cpu_take_the_eager_path(moe):
    """``decode_step_paged(..., graphs=...)`` on the CPU is the eager step:
    the same logits, positions and pool writes as without the keyword,
    and nothing captured or replayed."""
    cfg = _cfg(moe)
    params = init_torch_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(5)
    pools = [T.init_block_pool(cfg, 40, 8, device="cpu") for _ in range(2)]
    for kk in ("k", "v"):
        pools[0][kk].normal_(generator=g)
        pools[1][kk].copy_(pools[0][kk])
    tables = torch.randint(1, 40, (cfg.num_layers, 3, 4), generator=g,
                           dtype=torch.int32)
    pos = torch.tensor([5, 0, 30], dtype=torch.int32)
    toks = torch.tensor([3, 0, 95], dtype=torch.int64)
    graphs = DecodeGraphs("cpu")
    for impl in ("plain", "kernel"):    # on the CPU "kernel" runs the plain
        ref = T.decode_step_paged(params, cfg, pools[0], tables, pos, toks,
                                  impl=impl)        # version of the kernel
        got = T.decode_step_paged(params, cfg, pools[1], tables, pos, toks,
                                  impl=impl, graphs=graphs)
        assert torch.equal(ref[0], got[0]) and torch.equal(ref[2], got[2])
        assert got[1] is pools[1]
        for kk in ("k", "v"):
            assert torch.equal(pools[0][kk], pools[1][kk])
    assert graphs.captures == graphs.replays == 0


def test_cpu_engine_replays_nothing():
    """A CPU engine keeps no graphs: its counters read 0 in ``describe``."""
    pre, dec = _engines(_cfg())
    tok, payload = pre.prefill(np.arange(10, dtype=np.int32))
    slot = dec.insert(types.SimpleNamespace(), payload)
    dec.decode_step({slot: tok})
    d = dec.describe()
    assert dec._graphs is None
    assert (d["graph_captures"], d["graph_replays"]) == (0, 0)


class _FakeGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: a replay runs
    the step on the capture's own tensors."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        for out, new in zip(self.outputs, self.fn(*self.inputs)):
            out.copy_(new)


def test_replay_bookkeeping():
    """A hit replays on the capture's inputs: foreign inputs are copied in
    first, the capture's own are not; a moved pinned tensor is refused;
    each replay advances a counter by what its capture launched."""
    counter = types.SimpleNamespace(launches=0)
    pool = torch.zeros(4)

    def body(a, b):
        return (a * 2 + b, a.sum(dim=0, keepdim=True))

    def step(a, b):             # what a capture would run: two launches
        counter.launches += 2
        return body(a, b)

    ins = (torch.arange(6.).reshape(2, 3), torch.ones(2, 3))
    outs = body(*ins)
    graphs = DecodeGraphs("cpu")
    graphs._graphs[graph_key(ins)] = _Graph(_FakeGraph(body, ins, outs),
                                            ins, outs, [pool.data_ptr()],
                                            [2])
    r = graphs.run(step, ins, pinned=(pool,), counters=(counter,))
    assert r is outs and counter.launches == 2 and graphs.replays == 1
    foreign = (torch.full((2, 3), 3.), torch.zeros(2, 3))
    r = graphs.run(step, foreign, pinned=(pool,), counters=(counter,))
    assert torch.equal(r[0], torch.full((2, 3), 6.))
    assert torch.equal(ins[0], foreign[0])      # copied into the capture's
    assert graphs.replays == 2 and graphs.captures == 0
    with pytest.raises(RuntimeError, match="moved"):
        graphs.run(step, ins, pinned=(pool.clone(),), counters=(counter,))
    assert graphs.replays == 2


def test_tick_leaves_untimed_seconds_off():
    """A step's measured time leaves out the seconds it spent capturing a
    graph: on the clock, in ``step_times`` and in what ``_tick`` returns."""
    _, dec = _engines(_cfg())
    clock = dec.clock
    dt = dec._tick(time.perf_counter() - 0.5, "decode", 0.4)
    assert 0.1 <= dt < 0.3
    assert dec.step_times[-1] == dt and dec.clock == clock + dt


def test_mean_step_compares_like_steps():
    """``mean_step_s`` (the straggler detector's input) is the mean of the
    recent steps of the kind the engine ran last: a prefill engine moved
    to the decode pool is judged by its decode steps, not by the longer
    prefills it brought along."""
    _, eng = _engines(_cfg())
    assert eng.mean_step_s == 0.0
    for dt in (0.05, 0.05, 0.05):
        eng._tick(time.perf_counter() - dt, "prefill")
    assert 0.05 <= eng.mean_step_s < 0.1
    eng._tick(time.perf_counter() - 0.01, "decode")
    assert 0.01 <= eng.mean_step_s < 0.04
    assert len(eng.step_times) == 4
