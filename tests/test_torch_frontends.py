"""The port's vision frontend (llava-next) against the JAX package on the
CPU: the converted parameters, ``input_specs`` / ``synth_inputs``,
``embed_inputs``, the prefills that take patch embeddings and the
training loss, on the same weights (carried across by
``repro_torch.convert``) and the same numpy-made inputs.

Tolerance: the inputs are equal bit for bit (``==``: torch's cast of the
float64 normals to bf16 rounds as ``jnp.asarray`` does, checked here).
The model runs in float32, where the two packages differ only in
summation order (XLA's einsums vs PyTorch's matmuls, online vs one-pass
softmax); over 2 layers and the LM head that stays below 1e-4 of the
output's scale (the bound of ``test_torch_model.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import transformer as JT
from repro.models.config import ShapeConfig as JShape
from repro.models.frontends import input_specs as j_input_specs
from repro.models.frontends import synth_inputs as j_synth_inputs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.models.frontends import input_specs, synth_inputs
from repro_torch.train.train_step import loss_and_grad
from repro_torch.tree import flatten_with_paths

TOL = 1e-4
LLAVA = "llava-next-34b"
SHAPES = [("train", 40, 2), ("prefill", 24, 2), ("decode", 1, 3)]


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _close(got, want, what, tol=TOL):
    got, want = (np.asarray(_np(t), np.float64) for t in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)
    assert err < tol, f"{what}: max err {err:.3e} of the scale"


def _setup(dtype="float32"):
    jcfg = jax_get_smoke(LLAVA).replace(dtype=dtype)
    cfg = get_smoke_config(LLAVA).replace(dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _inputs(jcfg, cfg, kind, S, B, seed=0):
    return (j_synth_inputs(jcfg, JShape("t", S, B, kind), seed),
            synth_inputs(cfg, ShapeConfig("t", S, B, kind), seed,
                         device="cpu"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_from_reference_carries_llavas_nested_vis_proj(dtype):
    """The repair: a nested top-level dict (``vis_proj``) is converted leaf
    by leaf, not into a numpy object array; every leaf equal."""
    jcfg = jax_get_smoke(LLAVA).replace(dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    assert set(tp["vis_proj"]) == {"w1", "w2"}
    flat = dict(flatten_with_paths(tp))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[0] == "blocks":
            for i in range(jcfg.num_layers):
                got = flat["/".join(["blocks", str(i)] + keys[1:])]
                np.testing.assert_array_equal(_np(got), _np(leaf[i]))
        else:
            got = flat["/".join(keys)]
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_np(got), _np(leaf))


@pytest.mark.parametrize("arch", [LLAVA, "qwen2.5-3b"])
@pytest.mark.parametrize("kind,S,B", SHAPES)
def test_input_specs_and_synth_inputs_equal_the_reference(arch, kind, S, B):
    """Same keys in the same order, shapes and dtypes; the drawn tokens,
    labels and bf16 patch embeddings equal bit for bit."""
    jcfg, cfg = jax_get_smoke(arch), get_smoke_config(arch)
    jspec = j_input_specs(jcfg, JShape("t", S, B, kind))
    spec = input_specs(cfg, ShapeConfig("t", S, B, kind))
    assert list(spec) == list(jspec)
    for k, s in spec.items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == jspec[k].shape
        assert str(s.dtype).split(".")[1] == jspec[k].dtype.name
    jin, tin = _inputs(jcfg, cfg, kind, S, B, seed=3)
    assert list(tin) == list(jin)
    for k in jin:
        assert str(tin[k].dtype).split(".")[1] == jin[k].dtype.name
        np.testing.assert_array_equal(_np(tin[k]), _np(jin[k]))


def test_synth_inputs_full_llava_prompt_shape():
    """The card's vision prompt: 2,880 patch embeddings of 1,024 and 512
    text tokens make 3,392 positions (shapes only, on the meta device)."""
    cfg = get_config(LLAVA)
    spec = input_specs(cfg, ShapeConfig("vision", 3392, 1, "prefill"))
    assert tuple(spec["tokens"].shape) == (1, 512)
    assert tuple(spec["patch_embeds"].shape) == (1, 2880, 1024)
    assert spec["patch_embeds"].dtype == torch.bfloat16


def test_init_params_draws_vis_proj_at_the_reference_scales():
    cfg = get_smoke_config(LLAVA).replace(dtype="float32", vision_dim=256,
                                          d_model=256, num_heads=4,
                                          num_kv_heads=2)
    p = T.init_params(cfg, 0, device="cpu")
    w1, w2 = p["vis_proj"]["w1"], p["vis_proj"]["w2"]
    assert tuple(w1.shape) == (256, 256) and tuple(w2.shape) == (256, 256)
    for w, fan_in in ((w1, cfg.vision_dim), (w2, cfg.d_model)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.02
    assert "vis_proj" not in T.init_params(get_smoke_config("qwen2.5-3b"), 0,
                                           device="cpu")


@pytest.mark.parametrize("with_patches", [True, False])
def test_embed_inputs_matches_reference(with_patches):
    """Patches projected (tanh GELU in fp32) and prepended, mask False
    over them; without patches the token embeddings and no mask."""
    jcfg, cfg, jp, tp = _setup()
    jin, tin = _inputs(jcfg, cfg, "prefill", 24, 2)
    if not with_patches:
        jin, tin = {"tokens": jin["tokens"]}, {"tokens": tin["tokens"]}
    jemb, jmask = JT.embed_inputs(jp, jcfg, jin)
    emb, mask = T.embed_inputs(tp, cfg, tin)
    _close(emb, jemb, "embeddings", tol=1e-6)
    if with_patches:
        P = cfg.vision_patches
        assert emb.shape[1] == P + tin["tokens"].shape[1]
        np.testing.assert_array_equal(_np(mask), _np(jmask))
        assert not mask[:, :P].any() and mask[:, P:].all()
    else:
        assert mask is None and jmask is None


def test_the_vision_gelu_is_the_tanh_form():
    """``jax.nn.gelu``'s default is the tanh approximation; the erf form
    (``F.gelu``'s default) differs by more than the tolerance."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = torch.nn.functional.gelu(t, approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(t).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_llava_prefill_full_and_decode_match_reference(impl):
    jcfg, cfg, jp, tp = _setup()
    jin, tin = _inputs(jcfg, cfg, "prefill", 24, 2)
    jl, jc = JT.prefill_full(jp, jcfg, jin, capacity=32)
    with torch.inference_mode():
        tl, tc = T.prefill_full(tp, cfg, tin, capacity=32, impl=impl)
        _close(tl, jl, "prefill logits")
        for key in ("k", "v"):
            _close(tc[key], jc[key], f"cache {key}")
        assert int(tc["pos"][0]) == 24 == int(jc["pos"][0])
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl2, _ = JT.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl2, _ = T.decode_step(tp, cfg, tc, torch.from_numpy(nxt), impl=impl)
        _close(tl2, jl2, "decode logits")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_llava_prefill_chunked_paged_with_patches_matches_reference(impl):
    """The patch positions go through the chunks like any others: 8
    patches + 16 tokens in 3 chunks of 8, straight into the blocks."""
    jcfg, cfg, jp, tp = _setup()
    jin, tin = _inputs(jcfg, cfg, "prefill", 24, 1)
    Bs, nb, Lr = 4, 8, cfg.num_layers
    tables = np.arange(1, 1 + Lr * nb, dtype=np.int32).reshape(Lr, nb)
    jpool = JT.init_block_pool(jcfg, 1 + Lr * nb, Bs)
    jl, jpool = JT.prefill_chunked_paged(jp, jcfg, jin, 8, jpool,
                                         jnp.asarray(tables))
    pool = T.init_block_pool(cfg, 1 + Lr * nb, Bs, device="cpu")
    with torch.inference_mode():
        tl, pool = T.prefill_chunked_paged(tp, cfg, tin, 8, pool,
                                           torch.from_numpy(tables),
                                           impl=impl)
    _close(tl, jl, "paged prefill logits")
    for key in ("k", "v"):
        _close(pool[key], jpool[key], f"pool {key}")


def test_llava_prefill_chunked_with_patches_matches_reference():
    jcfg, cfg, jp, tp = _setup()
    jin, tin = _inputs(jcfg, cfg, "prefill", 24, 2)
    jl, jc = JT.prefill_chunked(jp, jcfg, jin, 8, capacity=32)
    with torch.inference_mode():
        tl, tc = T.prefill_chunked(tp, cfg, tin, 8, capacity=32,
                                   impl="plain")
    _close(tl, jl, "chunked prefill logits")
    _close(tc["k"], jc["k"], "cache k")


def test_llava_train_loss_and_grads_match_reference():
    """The patch positions are never scored (``mask & vis_mask``), and
    every grad, ``vis_proj``'s included, is the reference's."""
    jcfg, cfg, jp, tp = _setup()
    jin, tin = _inputs(jcfg, cfg, "train", 40, 2)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.train_loss(p, jcfg, jin), has_aux=True)(jp)
    loss, metrics, grads = loss_and_grad(tp, cfg, tin)
    _close(loss, jl, "loss", tol=1e-6)
    _close(metrics["ce"], jm["ce"], "ce", tol=1e-6)
    want = dict(flatten_with_paths(
        from_reference(jax.tree.map(np.asarray, jg), device="cpu")))
    for path, g in flatten_with_paths(grads):
        _close(g, want[path], f"grad {path}")
    assert float(grads["vis_proj"]["w1"].abs().max()) > 0
    # the labels under the patches do not count: changing them changes
    # nothing, changing a text label does
    P = cfg.vision_patches
    moved = dict(tin, labels=tin["labels"].clone())
    moved["labels"][:, :P] = (moved["labels"][:, :P] + 1) % cfg.vocab_size
    assert float(loss_and_grad(tp, cfg, moved)[0]) == float(loss)
    moved["labels"][:, P] = (moved["labels"][:, P] + 1) % cfg.vocab_size
    assert float(loss_and_grad(tp, cfg, moved)[0]) != float(loss)
