"""The two 14B dense-attention configurations of the port (``qwen3-14b``:
qk_norm, 40/8 heads, G = 5; ``phi3-medium-14b``: 40/10 heads, vocabulary
100352) against the JAX package on the CPU, on the same weights (the JAX
parameters carried across by ``repro_torch.convert``) and the same
numpy-made tokens, pools and block tables.

Cases, all float32:

- ``smoke``: each configuration's own smoke size (4/2 and 4/1 heads,
  dh 16, 2 layers);
- ``g5``: qwen3-14b cut to 10/2 heads (G = 5, the full model's group),
  d_model 160, dh 16, 2 layers — five query heads per KV head, which the
  flash kernel packs 12 positions to a 64-row tile on the card;
- ``heads``: each full configuration's head geometry (40/8 or 40/10
  heads, dh 128, d_model 5120) at 2 layers with a narrow FFN and
  vocabulary, the shapes the card's kernels take in phase 16.

The JAX side runs ``impl="xla"`` and ``impl="pallas"`` (its Pallas kernels
in interpret mode); the port runs ``impl="kernel"`` (whose wrappers take
their plain versions for CPU tensors) and ``impl="plain"``.

Tolerance: 1e-4 of the logits' scale, as ``tests/test_torch_model.py``:
the two packages differ only in summation order, which compounds over two
layers and the head to ~3e-6 at a scale of ~3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import transformer as JT
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Engine as JEngine
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.core.hardware import get_chip
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving.backends import make_engine
from repro_torch.serving.cluster import Cluster
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   StaticWorkload, materialize)
# the helpers of the qwen2.5-3b parity tests (the same 1e-4 tolerance)
from test_torch_model import (Bs, _close, _decode_setup,  # noqa: F401
                              pallas_interpret)

ARCHS = ("qwen3-14b", "phi3-medium-14b")
CASES = ("qwen3-14b-smoke", "phi3-medium-14b-smoke", "qwen3-14b-g5",
         "qwen3-14b-heads", "phi3-medium-14b-heads")


def _configs(case: str):
    """(JAX config, port config) of a case, float32."""
    arch, kind = case.rsplit("-", 1)
    if kind == "smoke":
        cut = dict(dtype="float32")
        return (jax_get_smoke(arch).replace(**cut),
                get_smoke_config(arch).replace(**cut))
    if kind == "g5":
        cut = dict(num_layers=2, d_model=160, num_heads=10, num_kv_heads=2,
                   d_ff=192, vocab_size=128, dtype="float32")
    else:
        cut = dict(num_layers=2, d_ff=256, vocab_size=512, dtype="float32")
    return (jax_get_config(arch).replace(**cut),
            get_config(arch).replace(**cut))


@functools.lru_cache(maxsize=None)
def _params(case: str):
    jcfg, _ = _configs(case)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_impl(jax_impl, request):
    if jax_impl == "pallas":
        request.getfixturevalue("pallas_interpret")
    return jax_impl


# ---------------------------------------------------------------------------
# Config mirror and init


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirror_matches_reference(arch, full):
    jcfg = (jax_get_config if full else jax_get_smoke)(arch)
    cfg = (get_config if full else get_smoke_config)(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("dh", "q_group", "padded_heads", "padded_kv_heads",
                 "padded_vocab", "can_group_decode", "is_attention_free",
                 "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    for fn in ("param_count", "active_param_count", "kv_bytes_per_token"):
        assert getattr(cfg, fn)() == getattr(jcfg, fn)(), fn
    assert cfg.tdtype == torch.bfloat16
    assert arch in ARCH_IDS
    if full:        # the figures the port's docs quote
        heads = {"qwen3-14b": (40, 8, 5, True, 151936),
                 "phi3-medium-14b": (40, 10, 4, False, 100352)}[arch]
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.q_group, cfg.qk_norm,
                cfg.vocab_size) == heads
        assert (cfg.num_layers, cfg.d_model, cfg.dh) == (40, 5120, 128)
        assert T.unported(cfg) is None
        assert cfg.kv_bytes_per_token() == 40 * 2 * cfg.num_kv_heads * 128 * 2


@pytest.mark.parametrize("case", ["qwen3-14b-smoke", "phi3-medium-14b-smoke",
                                  "qwen3-14b-g5"])
def test_init_params_layout_matches_reference(case):
    """Same leaves and shapes as the reference's init: qwen3-14b carries
    its per-head q_norm/k_norm scales and no QKV bias; phi3 neither."""
    jcfg, cfg = _configs(case)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    p = T.init_params(cfg, 0, device="cpu")
    assert set(p) == set(jp)
    assert len(p["blocks"]) == cfg.num_layers
    assert set(p["blocks"][0]) == set(jp["blocks"])
    for name, leaf in jp["blocks"].items():
        assert tuple(p["blocks"][0][name].shape) == leaf.shape[1:], name
    assert ("q_norm" in p["blocks"][0]) == cfg.qk_norm
    assert "bq" not in p["blocks"][0]


# ---------------------------------------------------------------------------
# Prefill, paged decode, chunked prefill (dense and paged)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_full_matches_reference(case, jax_impl, request):
    jax_impl = _jax_impl(jax_impl, request)
    jcfg, cfg = _configs(case)
    jp, tp = _params(case)
    S = 29                              # no multiple of any kernel tile
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    jl, jc = JT.prefill_full(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                             impl=jax_impl)
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_full(tp, cfg, {"tokens": torch.from_numpy(tokens)},
                                impl=impl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        _close(tl, jl, f"logits ({impl})")
        _close(tc["k"], jc["k"], f"cache k ({impl})")
        _close(tc["v"], jc["v"], f"cache v ({impl})")


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_decode_step_paged_matches_reference(case, jax_impl, request):
    jax_impl = _jax_impl(jax_impl, request)
    jcfg, cfg = _configs(case)
    jp, tp = _params(case)
    S, slots, live, steps = 19, 3, 2, 3
    pool, tables, pos, toks = _decode_setup(cfg, jp, jcfg, S, slots, live,
                                            steps)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpools = {impl: {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
              for impl in ("kernel", "plain")}
    tbl_j, tbl_t = jnp.asarray(tables), torch.from_numpy(tables)
    for step in range(steps):
        jl, jpool, _ = JT.decode_step_paged(
            jp, jcfg, jpool, tbl_j, jnp.asarray(pos), jnp.asarray(toks),
            impl=jax_impl)
        for impl, tpool in tpools.items():
            tl, out_pool, new_pos = T.decode_step_paged(
                tp, cfg, tpool, tbl_t, torch.from_numpy(pos),
                torch.from_numpy(toks), impl=impl)
            assert out_pool is tpool
            assert np.asarray(new_pos).tolist() == (pos + 1).tolist()
            _close(tl, jl, f"step {step} logits ({impl})")
        toks[:live] = np.asarray(jnp.argmax(jl, -1))[:live]
        pos[:live] += 1
    for impl, tpool in tpools.items():
        for kk in ("k", "v"):
            _close(tpool[kk][1:], np.asarray(jpool[kk])[1:],
                   f"pool {kk} ({impl})")


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_chunked_paged_matches_reference(case, jax_impl, request):
    """Chunked prefill into shuffled pool blocks, fresh and resumed after
    a prefix (``start=``): the logits and the blocks the chunks wrote."""
    jax_impl = _jax_impl(jax_impl, request)
    jcfg, cfg = _configs(case)
    jp, tp = _params(case)
    S, chunk = 32, 16
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (1, S))
    Lr, nbk = cfg.num_layers, S // Bs
    N = 1 + Lr * nbk + 5
    tables = rng.permutation(np.arange(1, N))[:Lr * nbk].astype(
        np.int32).reshape(Lr, nbk)
    pool = {kk: np.zeros((N, Bs, cfg.padded_kv_heads, cfg.dh), np.float32)
            for kk in ("k", "v")}
    jl, jpool = JT.prefill_chunked_paged(
        jp, jcfg, {"tokens": jnp.asarray(tokens)}, chunk,
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        impl=jax_impl)
    for impl in ("kernel", "plain"):
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        tl, _ = T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens)}, chunk, tpool,
            torch.from_numpy(tables), impl=impl)
        _close(tl, jl, f"logits ({impl})")
        for kk in ("k", "v"):
            _close(tpool[kk][tables], np.asarray(jpool[kk])[tables],
                   f"blocks {kk} ({impl})")
        rpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens[:, :chunk])}, chunk,
            rpool, torch.from_numpy(tables[:, :chunk // Bs]), impl=impl)
        rl, _ = T.prefill_chunked_paged(
            tp, cfg, {"tokens": torch.from_numpy(tokens)}, chunk, rpool,
            torch.from_numpy(tables), start=chunk, impl=impl)
        _close(rl, jl, f"resumed logits ({impl})")


@pytest.mark.parametrize("case", CASES)
def test_prefill_chunked_matches_reference(case):
    """Dense chunked prefill, fresh and resumed from a cached prefix, and
    dense decode steps after it."""
    jcfg, cfg = _configs(case)
    jp, tp = _params(case)
    S, chunk, C, start = 32, 16, 40, 16
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, S))
    jl, jc = JT.prefill_chunked(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                chunk, capacity=C)
    _, jpre = JT.prefill_chunked(
        jp, jcfg, {"tokens": jnp.asarray(tokens[:, :start])}, chunk,
        capacity=C)
    jlr, _ = JT.prefill_chunked(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                chunk, capacity=C, cache=jpre, start=start)
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jd, _ = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks))
    for impl in ("kernel", "plain"):
        tl, tc = T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens)}, chunk, capacity=C, impl=impl)
        _close(tl, jl, f"fresh logits ({impl})")
        for kk in ("k", "v"):
            _close(tc[kk], jc[kk], f"fresh cache {kk} ({impl})")
        _, tpre = T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens[:, :start])}, chunk, capacity=C, impl=impl)
        tlr, _ = T.prefill_chunked(tp, cfg, {"tokens": torch.from_numpy(
            tokens)}, chunk, capacity=C, impl=impl, cache=tpre, start=start)
        _close(tlr, jlr, f"resumed logits ({impl})")
        td, _ = T.decode_step(tp, cfg, tc, torch.from_numpy(toks), impl=impl)
        _close(td, jd, f"decode after chunks ({impl})")


# ---------------------------------------------------------------------------
# Serving


N_REQ, ISL, OSL, SLOTS = 4, 24, 5, 2


@pytest.mark.parametrize("case", ["qwen3-14b-smoke", "phi3-medium-14b-smoke",
                                  "qwen3-14b-g5"])
def test_cluster_serve_token_streams_match_reference(case):
    """A disaggregated cluster (1 prefill + 2 decode engines) on the same
    float32 weights: every request's greedy stream equals the reference's
    (logits agree to ~1e-6, far from any tie at this size)."""
    jcfg, cfg = _configs(case)
    jp, tp = _params(case)
    kw = dict(vocab=cfg.vocab_size, seed=3, max_requests=N_REQ,
              horizon_s=3600.0)
    jreqs = jmaterialize(JOpenLoopWorkload(JBurst(N_REQ),
                                           JFixedShape(ISL, OSL), **kw))
    treqs = materialize(OpenLoopWorkload(Burst(N_REQ), FixedShape(ISL, OSL),
                                         **kw))
    jeng = [JEngine(i, jcfg, jp, slots=SLOTS, capacity=ISL + OSL + 8)
            for i in (0, 100, 101)]
    JCluster({"prefill": jeng[:1], "decode": jeng[1:]}).serve(
        JStaticWorkload(jreqs))
    teng = [make_engine("torch", i, cfg, tp, slots=SLOTS,
                        capacity=ISL + OSL + 8, chip=get_chip("h100"),
                        device="cpu") for i in (0, 100, 101)]
    m = Cluster({"prefill": teng[:1], "decode": teng[1:]}).serve(
        StaticWorkload(treqs))
    assert m["completed"] == N_REQ
    assert {r.rid: r.output for r in treqs} == \
        {r.rid: r.output for r in jreqs}
    assert all(len(r.output) == OSL for r in treqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_14b_smoke_on_cpu(arch, capsys):
    """``--arch qwen3-14b`` / ``--arch phi3-medium-14b`` through the
    launcher (smoke size, CPU), disaggregated and co-located."""
    for extra in ([], ["--mode", "coloc", "--piggyback-chunk", "8"]):
        rec = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--isl", "32", "--osl", "4"]
                         + extra)
        assert rec["completed"] == 3
        assert rec["arch"] == f"{arch}-smoke"
