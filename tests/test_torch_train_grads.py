"""``train_loss`` and its grads, the port against the JAX package on the
CPU: every family at smoke size, remat and ragged chunks, padded
vocabulary and heads, grad accumulation, and a training forward that
reaches no kernel. The same weights (the JAX init carried across by
``repro_torch.convert``) and the same numpy-made batches.

Tolerance: float32, where the two packages differ only in summation order
(XLA's einsums and reductions vs PyTorch's): the loss and the metrics
within 1e-5 of their scale, each grad leaf — layer by layer against the
reference's stacked axis — within 1e-4 of its scale (2 layers, the bound
of ``test_torch_model.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ShapeConfig as JShape
from repro.models.frontends import synth_inputs as j_synth_inputs
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.frontends import synth_inputs
from repro_torch.train.train_step import loss_and_grad
from repro_torch.tree import flatten_with_paths, leaves

TOL = 1e-4
TINY = dict(name="train-tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
            remat=False, logits_chunk=32, dtype="float32")
JCFG, CFG = JModelConfig(**TINY), ModelConfig(**TINY)


def _close(got, want, what, tol=TOL):
    got, want = (np.asarray(t.detach().numpy() if torch.is_tensor(t) else t,
                            np.float64) for t in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)
    assert err < tol, f"{what}: max err {err:.3e} of the scale"


def _ported(jtree):
    """A JAX params-shaped tree in the port's layout, by key path."""
    return dict(flatten_with_paths(
        from_reference(jax.tree.map(np.asarray, jtree), device="cpu")))


def _weights(jcfg):
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def test_training_forward_runs_no_kernel(monkeypatch):
    """No hand-written kernel has a backward: the training loss must not
    reach a kernel wrapper."""
    def no_kernel(*args, **kw):
        raise AssertionError("a kernel wrapper was called")

    for name in ("flash_attention", "decode_attention",
                 "decode_attention_paged"):
        monkeypatch.setattr(T, name, no_kernel)
    monkeypatch.setattr(T.rwkv6, "wkv", no_kernel)
    for arch in ("qwen2.5-3b", "rwkv6-1.6b", "hymba-1.5b"):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        batch = synth_inputs(cfg, ShapeConfig("t", 24, 2, "train"),
                             device="cpu")
        loss, _, _ = loss_and_grad(T.init_params(cfg, 0, device="cpu"), cfg,
                                   batch)
        assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# The loss and its grads, every family


def _loss_and_grads_match(jcfg, cfg, S, B=2):
    jp, tp = _weights(jcfg)
    jb = j_synth_inputs(jcfg, JShape("t", S, B, "train"))
    tb = synth_inputs(cfg, ShapeConfig("t", S, B, "train"), device="cpu")
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, jcfg, b), has_aux=True))(jp, jb)
    loss, metrics, grads = loss_and_grad(tp, cfg, tb)
    _close(loss, jl, "loss", tol=1e-5)
    for k in jm:
        _close(metrics[k], jm[k], f"metric {k}", tol=1e-5)
    want = _ported(jg)
    got = dict(flatten_with_paths(grads))
    assert set(got) == set(want)
    for path in want:           # layer by layer against the stacked axis
        assert got[path].dtype == torch.float32
        _close(got[path], want[path], f"grad {path}")


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "llava-next-34b"])
def test_train_loss_and_grads_match_reference(arch):
    """Every family at smoke size (llava's in test_torch_frontends.py):
    dense (qkv bias, qk-norm), MoE with and without a shared expert,
    RWKV-6 from a zero state, and the hybrid past its window of 16."""
    _loss_and_grads_match(jax_get_smoke(arch).replace(dtype="float32"),
                          get_smoke_config(arch).replace(dtype="float32"),
                          S=32)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-1.6b",
                                  "hymba-1.5b"])
def test_remat_and_ragged_chunks_match_reference(arch):
    """``cfg.remat`` (per-layer ``torch.utils.checkpoint``) and S = 45: a
    ragged CE chunk, WKV chunk and SSM chunk."""
    _loss_and_grads_match(
        jax_get_smoke(arch).replace(dtype="float32", remat=True),
        get_smoke_config(arch).replace(dtype="float32", remat=True), S=45)


def test_padded_vocab_and_heads_match_reference():
    """Padded vocabulary rows masked out of the CE, padded query heads
    zeroed: both grads as the reference's."""
    cut = dict(vocab_pad=7, pad_heads_to=3)
    _loss_and_grads_match(JCFG.replace(**cut), CFG.replace(**cut), S=24)


def test_grad_accumulation_matches_full_batch():
    params = T.init_params(CFG, 0, device="cpu")
    batch = make_pipeline(CFG, seq_len=16, global_batch=8,
                          device="cpu").batch_at(0)
    l1, _, g1 = loss_and_grad(params, CFG, batch)
    l2, m2, g2 = loss_and_grad(params, CFG.replace(grad_accum=4), batch)
    assert abs(float(l1) - float(l2)) < 1e-5
    assert set(m2) == {"ce", "moe_aux_loss", "moe_z_loss", "moe_dropped"}
    for a, b in zip(leaves(g1), leaves(g2)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
