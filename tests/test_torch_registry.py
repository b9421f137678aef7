"""The port's architecture registry against the JAX package's, on the CPU.

All ten configurations, full and smoke, equal the reference's field for
field; the registry helpers (``all_configs``, ``get_shape``, ``cells``)
give the same answers; every id bridges to the same analytic model and
resolves through ``get_perf_model``; the smoke configurations of the
four newest ids that the torch backend serves give the reference's greedy
token streams on float32 weights (musicgen-large: multi-head attention,
G = 1; mistral-large-123b: 6/2 heads over 3 layers; kimi-k2-1t-a32b: an
MoE FFN with a shared expert, the first whole model in the port with
one). Equality of streams is exact, as in ``tests/test_torch_serving.py``:
greedy argmax over float32 logits nowhere near a tie at this size.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.core.paper_models import get_perf_model as jget_perf_model
from repro.core.paper_models import perf_llm_from_config as jbridge
from repro.models import transformer as JT
from repro.serving.cluster import Cluster as JCluster
from repro.serving.engine import Engine as JEngine
from repro.workloads import Burst as JBurst
from repro.workloads import FixedShape as JFixedShape
from repro.workloads import OpenLoopWorkload as JOpenLoopWorkload
from repro.workloads import StaticWorkload as JStaticWorkload
from repro.workloads import materialize as jmaterialize
import repro_torch.configs as C
from repro_torch.convert import from_reference
from repro_torch.core.paper_models import get_perf_model, perf_llm_from_config
from repro_torch.models import transformer as T
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import Engine
from repro_torch.workloads import (Burst, FixedShape, OpenLoopWorkload,
                                   StaticWorkload, materialize)

NEW = ("musicgen-large", "mistral-large-123b", "llava-next-34b",
       "kimi-k2-1t-a32b")


def test_arch_ids_are_the_reference_s_ten_in_order():
    assert C.ARCH_IDS == JC.ARCH_IDS and len(C.ARCH_IDS) == 10
    assert set(NEW) <= set(C.ARCH_IDS)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_mirrors_reference(arch):
    for full in (True, False):
        cfg = (C.get_config if full else C.get_smoke_config)(arch)
        jcfg = (JC.get_config if full else JC.get_smoke_config)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        # the port-only settings (init-only, outside asdict) at their
        # defaults, which mean what the reference's configuration means
        for obj in (cfg, cfg.moe):
            for name in getattr(obj, "PORT_ONLY", ()):
                assert getattr(obj, name) == getattr(type(obj), name), name
        for prop in ("dh", "q_group", "padded_heads", "padded_kv_heads",
                     "padded_vocab", "can_group_decode", "is_attention_free",
                     "sub_quadratic"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        for fn in ("param_count", "active_param_count",
                   "kv_bytes_per_token"):
            assert getattr(cfg, fn)() == getattr(jcfg, fn)(), fn


def test_registry_helpers_match_reference():
    mine, ref = C.all_configs(), JC.all_configs()
    assert list(mine) == list(ref) == list(C.ARCH_IDS)
    assert {a: dataclasses.asdict(c) for a, c in mine.items()} == \
        {a: dataclasses.asdict(c) for a, c in ref.items()}
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.asdict(C.get_shape(name)) == \
            dataclasses.asdict(JC.get_shape(name))
    with pytest.raises(KeyError):
        C.get_shape("nope")
    for skips in (False, True):
        assert list(C.cells(include_skips=skips)) == \
            list(JC.cells(include_skips=skips))
    # the sub-quadratic families run long_500k, the rest skip it
    runnable = {(a, s) for a, s, ok, _ in C.cells(True) if ok}
    assert ("rwkv6-1.6b", "long_500k") in runnable
    assert ("hymba-1.5b", "long_500k") in runnable
    assert ("kimi-k2-1t-a32b", "long_500k") not in runnable


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_perf_llm_bridge_and_get_perf_model_match_reference(arch):
    mine = perf_llm_from_config(C.get_config(arch))
    assert dataclasses.asdict(mine) == dataclasses.asdict(
        jbridge(JC.get_config(arch)))
    assert dataclasses.asdict(get_perf_model(arch)) == \
        dataclasses.asdict(jget_perf_model(arch))


def test_the_new_configurations_figures():
    """The figures the port's documents quote: parameters, bf16 weights
    against one card's 80 GiB, and musicgen's handoff at 512 tokens."""
    counts = {a: C.get_config(a).param_count() for a in NEW}
    assert round(counts["musicgen-large"] / 1e9, 4) == 3.2298
    assert round(counts["mistral-large-123b"] / 1e9, 1) == 122.6
    assert round(counts["kimi-k2-1t-a32b"] / 1e9, 1) == 1044.9
    card = 80 * 2**30
    assert 2 * counts["musicgen-large"] < card
    assert 2 * counts["llava-next-34b"] < card
    assert 2 * counts["mistral-large-123b"] > card
    assert 2 * counts["kimi-k2-1t-a32b"] > card
    mg = C.get_config("musicgen-large")
    assert (mg.num_layers, mg.num_heads, mg.num_kv_heads, mg.dh, mg.q_group,
            mg.vocab_size, mg.frontend) == (48, 32, 32, 64, 1, 2048, None)
    assert 512 * mg.kv_bytes_per_token() == 201_326_592 == 192 * 2**20
    for arch in ("musicgen-large", "mistral-large-123b", "kimi-k2-1t-a32b",
                 "llava-next-34b"):
        assert T.unported(C.get_config(arch)) is None
        assert T.unported(C.get_smoke_config(arch)) is None


def _requests(jax_side: bool, vocab: int):
    mods = ((jmaterialize, JOpenLoopWorkload, JBurst, JFixedShape)
            if jax_side else
            (materialize, OpenLoopWorkload, Burst, FixedShape))
    mat, wl, burst, shape = mods
    return mat(wl(burst(4), shape(16, 5), vocab=vocab, seed=2,
                  max_requests=4, horizon_s=3600.0))


@pytest.mark.parametrize("arch", ["musicgen-large", "mistral-large-123b",
                                  "kimi-k2-1t-a32b"])
def test_smoke_engines_stream_like_reference(arch):
    """Disaggregated serving (1 prefill + 1 decode engine of 2 slots, the
    paged layout) of the smoke configuration on float32 weights: the
    reference's greedy streams, transfer count and bytes."""
    jcfg = JC.get_smoke_config(arch).replace(dtype="float32")
    cfg = C.get_smoke_config(arch).replace(dtype="float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    if cfg.moe is not None:
        assert cfg.moe.num_shared_experts == 1
        assert "shared_wg" in tp["blocks"][0]["moe"]
    jreqs, treqs = _requests(True, cfg.vocab_size), _requests(
        False, cfg.vocab_size)
    jeng = [JEngine(i, jcfg, jp, slots=2, capacity=32) for i in (0, 1)]
    jcl = JCluster({"prefill": jeng[:1], "decode": jeng[1:]})
    assert jcl.serve(JStaticWorkload(jreqs))["completed"] == 4
    teng = [Engine(i, cfg, tp, slots=2, capacity=32, device="cpu")
            for i in (0, 1)]
    assert all(e.paged for e in teng)
    tcl = Cluster({"prefill": teng[:1], "decode": teng[1:]})
    assert tcl.serve(StaticWorkload(treqs))["completed"] == 4
    assert {r.rid: list(r.output) for r in treqs} == \
        {r.rid: list(r.output) for r in jreqs}
    assert all(len(r.output) == 5 for r in treqs)
    assert tcl.stats.transfers == jcl.stats.transfers
    assert tcl.stats.transferred_bytes == jcl.stats.transferred_bytes
