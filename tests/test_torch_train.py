"""The port's training substrate against the JAX package on the CPU: the
attention functions the training forward runs, AdamW / Adafactor and the
schedule, the data pipeline, checkpoints (each package restoring what the
other saved), the trainer (crash and resume, and trainer against trainer)
and the launcher. ``train_loss`` and its grads for every family are in
``test_torch_train_grads.py``.

Tolerances: float32 throughout, where the two packages differ only in
summation order (XLA's einsums and reductions vs PyTorch's): an attention
output or grad within 1e-4 of its scale (the bound of
``test_torch_model.py``); the optimizers' one-step arithmetic
within 1e-6 relative. Data batches and checkpoint leaves are compared
with ``==``. Trainer against trainer runs 6 AdamW steps: AdamW's first
step turns near-zero grads into +-lr whatever their size, so parameters
are compared by relative L2 norm (1e-3), not element by element, and the
losses per step within 1e-4.
"""
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import MemmapLM as JMemmapLM
from repro.data.pipeline import make_pipeline as j_make_pipeline
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.train import optimizer as JO
from repro.train.trainer import Trainer as JTrainer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import from_reference
from repro_torch.data.pipeline import DataConfig, MemmapLM, make_pipeline
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import StragglerMonitor, Trainer
from repro_torch.tree import flatten_with_paths, leaves

TOL = 1e-4
TINY = dict(name="train-tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
            remat=False, logits_chunk=32, dtype="float32")
JCFG, CFG = JModelConfig(**TINY), ModelConfig(**TINY)


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


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(_np(t), np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _ported(jtree):
    """A JAX params-shaped tree in the port's layout, by key path."""
    return dict(flatten_with_paths(
        from_reference(jax.tree.map(np.asarray, jtree), device="cpu")))


def _weights(jcfg):
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# The attention functions of the training forward


def _qkv(shape, seed=0, kv_shape=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(kv_shape or shape).astype(np.float32),
            rng.standard_normal(kv_shape or shape).astype(np.float32)]
    return arrs, [torch.from_numpy(a) for a in arrs]


ATTN_CASES = {
    # S = 64 over blocks of 16: the causal triangle recursed three times,
    # the rectangles scanned over KV blocks
    "causal": (lambda m, q, k, v: m.causal_attention_xla(q, k, v, block=16),
               (2, 64, 4, 16)),
    "causal_one_block": (lambda m, q, k, v: m.causal_attention_xla(q, k, v),
                         (1, 40, 2, 16)),
    "chunked_prefill": (
        lambda m, q, k, v: m.chunked_prefill_attention_xla(
            q[:, 32:48], k[:, :48], v[:, :48], 32, block=16),
        (2, 64, 4, 16)),
    "sliding_window": (
        lambda m, q, k, v: m.sliding_window_attention_xla(q, k, v, 16),
        (2, 40, 4, 16)),
    "sliding_window_short": (
        lambda m, q, k, v: m.sliding_window_attention_xla(q, k, v, 64),
        (1, 40, 2, 16)),
    "dense_causal_window_offset": (
        lambda m, q, k, v: m.dense_attention(q[:, 24:], k, v, window=8,
                                             kv_offset=24),
        (2, 40, 4, 16)),
    "dense_full": (lambda m, q, k, v: m.dense_attention(q, k, v,
                                                        causal=False),
                   (1, 24, 2, 16)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_functions_and_their_grads_match_reference(case):
    fn, shape = ATTN_CASES[case]
    (jq, jk, jv), (q, k, v) = _qkv(shape, seed=len(case))
    jo = jax.jit(lambda a, b, c: fn(JL, a, b, c))(jq, jk, jv)
    for t in (q, k, v):
        t.requires_grad_()
    o = fn(L, q, k, v)
    _close(o, jo, f"{case} output")
    w = np.random.default_rng(9).standard_normal(jo.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(JL, a, b, c) * w),
                          argnums=(0, 1, 2)))(jq, jk, jv)
    g = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (q, k, v))
    for name, a, b in zip("qkv", g, jg):
        _close(a, b, f"{case} grad {name}")


def test_decode_attention_xla_and_repeat_kv_match_reference():
    (jq, jk, jv), (q, k, v) = _qkv((3, 1, 4, 16), kv_shape=(3, 20, 4, 16))
    pos = np.array([0, 7, 19], np.int32)[:, None, None, None]
    for window in (0, 5):
        jo = JL.decode_attention_xla(jnp.asarray(jq), jnp.asarray(jk),
                                     jnp.asarray(jv), jnp.asarray(pos),
                                     window=window)
        o = L.decode_attention_xla(q, k, v, torch.from_numpy(pos),
                                   window=window)
        _close(o, jo, f"decode window={window}")
    kv = np.random.default_rng(1).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        L.repeat_kv(torch.from_numpy(kv), 6).numpy(),
        np.asarray(JL.repeat_kv(jnp.asarray(kv), 6)))


# ---------------------------------------------------------------------------
# Optimizers


def test_cosine_schedule_matches_reference():
    for lr, warmup, total in ((3e-4, 5, 15), (1e-2, 2, 10_000)):
        jfn, fn = (JO.cosine_schedule(lr, warmup, total),
                   O.cosine_schedule(lr, warmup, total))
        for step in range(0, 20):
            np.testing.assert_allclose(float(fn(step)), float(jfn(step)),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_reference_on_equal_grads(name):
    """Two updates (steps 3 and 4 of a 2-step warmup) from the same
    parameters with the same grads: parameters and every state leaf."""
    jp, tp = _weights(JCFG)
    rng = np.random.default_rng(5)
    jopt, opt = (JO.make_optimizer(name, lr=1e-2, warmup=2),
                 O.make_optimizer(name, lr=1e-2, warmup=2))
    jstate, state = jopt.init(jp), opt.init(tp)
    for step in (3, 4):
        jg = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), jp)
        g = from_reference(jax.tree.map(np.asarray, jg), device="cpu")
        jp, jstate = jax.jit(jopt.update)(jg, jstate, jp, jnp.asarray(step))
        tp, state = opt.update(g, state, tp, step)
    want = _ported(jp)
    for path, p in flatten_with_paths(tp):
        _close(p, want[path], f"param {path}", tol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 2
    if name == "adamw":
        for key in ("m", "v"):
            want = _ported(jstate[key])
            for path, x in flatten_with_paths(state[key]):
                _close(x, want[path], f"{key} {path}", tol=1e-6)
    else:       # the reference's stacked [L, ...] moments, path for path
        want = dict(flatten_with_paths(jax.tree.map(np.asarray,
                                                    jstate["s"])))
        got = dict(flatten_with_paths(state["s"]))
        assert set(got) == set(want)
        for path in want:
            _close(got[path], want[path], f"state {path}", tol=1e-6)


def test_bf16_update_keeps_the_dtype_and_the_reference_values():
    jp, tp = _weights(JCFG.replace(dtype="bfloat16"))
    opt, jopt = O.make_optimizer("adamw", lr=1e-2, warmup=2), \
        JO.make_optimizer("adamw", lr=1e-2, warmup=2)
    jg = jax.tree.map(lambda x: jnp.ones(x.shape, jnp.float32) * 1e-3, jp)
    g = from_reference(jax.tree.map(np.asarray, jg), device="cpu")
    jp, _ = jopt.update(jg, jopt.init(jp), jp, jnp.asarray(3))
    tp, _ = opt.update(g, opt.init(tp), tp, 3)
    want = _ported(jp)
    for path, p in flatten_with_paths(tp):
        assert p.dtype == torch.bfloat16
        # within one bf16 rounding of the reference's fp32 update
        np.testing.assert_allclose(p.float().numpy(),
                                   want[path].float().numpy(),
                                   rtol=2 ** -8, atol=1e-6)


def test_adafactor_state_is_factored():
    params = T.init_params(CFG, 0, device="cpu")
    state = O.make_optimizer("adafactor").init(params)
    n_param = sum(x.numel() for x in leaves(params))
    n_state = sum(x.numel() for x in leaves(state["s"]))
    assert n_state < 0.25 * n_param      # factored: far below O(params)


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    jtree = {"a": jnp.full((10,), 3.0), "b": jnp.full((10,), 4.0)}
    clipped, norm = O.clip_by_global_norm(tree, 1.0)
    jclipped, jnorm = JO.clip_by_global_norm(jtree, 1.0)
    assert abs(float(norm) - np.sqrt(250.0)) < 1e-4
    assert float(norm) == float(jnorm)
    assert abs(float(O.global_norm(clipped)) - 1.0) < 1e-5
    for k in tree:
        np.testing.assert_array_equal(clipped[k].numpy(),
                                      np.asarray(jclipped[k]))


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(alpha=0.5, factor=3.0)
    for i in range(5):
        assert not mon.observe(i, 0.1)
    assert mon.observe(5, 1.0)          # 10x the EWMA -> flagged
    assert mon.events and mon.events[0]["step"] == 5


# ---------------------------------------------------------------------------
# Data and checkpoints


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_equal_the_reference(seed):
    jd = j_make_pipeline(JCFG, seq_len=16, global_batch=4, seed=seed)
    d = make_pipeline(CFG, seq_len=16, global_batch=4, seed=seed,
                      device="cpu")
    for step in (0, 1, 5):
        jb, b = jd.batch_at(step), d.batch_at(step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    b = d.batch_at(5)
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(),
                                  b["labels"][:, :-1].numpy())


def test_memmap_batches_equal_the_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 60000, size=5000).astype(
        np.uint16).tofile(path)
    jd = JMemmapLM(JDataConfig(vocab_size=97, seq_len=16, global_batch=4,
                               seed=2, path=path))
    d = MemmapLM(DataConfig(vocab_size=97, seq_len=16, global_batch=4,
                            seed=2, path=path), device="cpu")
    assert isinstance(make_pipeline(CFG, 16, 4, path=path, device="cpu"),
                      MemmapLM)
    for step in (0, 7):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(d.batch_at(step)[k].numpy(),
                                          np.asarray(jd.batch_at(step)[k]))


def _nested(rng):
    """A nested tree of bf16, fp32 and int32 leaves (dicts and a list),
    numpy float32 values with their bf16 bits."""
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(5).astype(np.float32),
                        "ids": rng.integers(-9, 9, (2, 2)).astype(np.int32)}
                       for _ in range(2)],
            "count": np.int32(7)}


def _as_jax(tree):
    return {"w": jnp.asarray(tree["w"], jnp.bfloat16),
            "layers": [{"b": jnp.asarray(l["b"]), "ids": jnp.asarray(l["ids"])}
                       for l in tree["layers"]],
            "count": jnp.asarray(tree["count"])}


def _as_torch(tree):
    return {"w": torch.from_numpy(tree["w"]).to(torch.bfloat16),
            "layers": [{"b": torch.from_numpy(l["b"]),
                        "ids": torch.from_numpy(l["ids"])}
                       for l in tree["layers"]],
            "count": torch.tensor(tree["count"])}


def test_checkpoints_restore_across_packages_bit_equal(tmp_path):
    tree = _nested(np.random.default_rng(0))
    zeros = _nested(np.random.default_rng(1))
    # the port saves, the reference restores
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, _as_torch(tree),
                         extra={"by": "port"})
    jgot, step, extra = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                                 _as_jax(zeros))
    assert step == 3 and extra == {"by": "port"}
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(_as_jax(tree))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    # the reference saves, the port restores
    jckpt.save_checkpoint(str(tmp_path / "ref"), 5, _as_jax(tree))
    got, step, _ = ckpt.restore_checkpoint(str(tmp_path / "ref"),
                                           _as_torch(zeros))
    assert step == 5 and ckpt.latest_step(str(tmp_path / "ref")) == 5
    for a, b in zip(leaves(got), leaves(_as_torch(tree))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    # the same files and manifest either way
    m = [json.load(open(tmp_path / d / f"step_0000000{s}" / "manifest.json"))
         for d, s in (("port", 3), ("ref", 5))]
    assert m[0]["leaves"] == m[1]["leaves"]
    assert [x["dtype"] for x in m[0]["leaves"]] == [
        "int32", "float32", "int32", "float32", "int32", "bfloat16"]


def test_checkpoint_refuses_another_tree_and_prunes(tmp_path):
    d = str(tmp_path)
    tree = _as_torch(_nested(np.random.default_rng(0)))
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, step, tree)
    ckpt.prune_checkpoints(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_checkpoint(d, {"w": tree["w"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, dict(tree, w=torch.zeros(4, 3)))


# ---------------------------------------------------------------------------
# The trainer and the launcher


def test_trainer_crash_resume_exact():
    """Crash at step k, resume: stream identical, loss path continues."""
    data = make_pipeline(CFG, seq_len=16, global_batch=4, device="cpu")
    d = tempfile.mkdtemp()
    d2 = tempfile.mkdtemp()
    try:
        t1 = Trainer(CFG, data, ckpt_dir=d, ckpt_every=4, lr=5e-3,
                     device="cpu")
        with pytest.raises(RuntimeError):
            t1.train(10, fail_at=6)
        t2 = Trainer(CFG, data, ckpt_dir=d, ckpt_every=4, lr=5e-3,
                     device="cpu")
        assert t2.init_or_restore() == 4
        t2.train(10)
        assert t2.step == 10
        t3 = Trainer(CFG, data, ckpt_dir=d2, ckpt_every=100, lr=5e-3,
                     device="cpu")
        t3.train(10)
        for a, b in zip(leaves(t2.params), leaves(t3.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
        assert [h["loss"] for h in t2.history] == [
            h["loss"] for h in t3.history[4:]]
    finally:
        shutil.rmtree(d)
        shutil.rmtree(d2)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_decreases_loss(opt_name):
    cfg = CFG.replace(optimizer=opt_name)
    params = T.init_params(cfg, 0, device="cpu")
    opt = O.make_optimizer(opt_name, lr=1e-2, warmup=2)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    data = make_pipeline(cfg, seq_len=16, global_batch=8, device="cpu")
    losses = []
    for i in range(12):
        params, state, m = step_fn(params, state, data.batch_at(i % 2), i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_trainer_matches_reference_trainer(monkeypatch, tmp_path):
    """6 steps of the reference's ``CFG`` from the same weights (the JAX
    init carried across) on the same batches: losses per step, then the
    parameters by relative L2 norm."""
    jp, tp = _weights(JCFG)
    monkeypatch.setattr(T, "init_params", lambda *a, **k: tp)
    jdata = j_make_pipeline(JCFG, seq_len=24, global_batch=4)
    data = make_pipeline(CFG, seq_len=24, global_batch=4, device="cpu")
    jt = JTrainer(JCFG, jdata, ckpt_dir=str(tmp_path / "j"), ckpt_every=5,
                  lr=5e-3)
    t = Trainer(CFG, data, ckpt_dir=str(tmp_path / "t"), ckpt_every=5,
                lr=5e-3, device="cpu")
    jt.train(6)
    t.train(6)
    for h, jh in zip(t.history, jt.history):
        for k in ("loss", "ce", "grad_norm"):
            assert abs(h[k] - jh[k]) <= TOL * max(abs(jh[k]), 1.0), (k, h, jh)
    want = _ported(jt.params)
    for path, p in flatten_with_paths(t.params):
        assert _rel_l2(p, want[path]) < 1e-3, path
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


def test_serving_then_training_roundtrip():
    """Train a few steps, then serve with the trained params: params flow
    trainer -> checkpoint -> engines, as the reference's system test."""
    from repro_torch.serving.backends import make_engine
    from repro_torch.serving.cluster import Cluster
    from repro_torch.workloads import FixedShape, OpenLoopWorkload, Poisson
    data = make_pipeline(CFG, seq_len=24, global_batch=4, device="cpu")
    d = tempfile.mkdtemp()
    try:
        tr = Trainer(CFG, data, ckpt_dir=d, ckpt_every=5, lr=5e-3,
                     device="cpu")
        tr.train(6)
        restored, step, _ = ckpt.restore_checkpoint(
            d, {"params": T.init_params(CFG, 1, device="cpu"),
                "opt": tr.opt.init(tr.params)})
        assert step == 6
        params = restored["params"]
        for a, b in zip(leaves(params), leaves(tr.params)):
            assert torch.equal(a, b)
        eng = [make_engine("torch", i, CFG, params, slots=2, capacity=48,
                           device="cpu") for i in (0, 1)]
        w = OpenLoopWorkload(Poisson(100.0), FixedShape(12, 4), vocab=97,
                             seed=9, max_requests=3, horizon_s=5.0)
        cluster = Cluster({"prefill": eng[:1], "decode": eng[1:]})
        m = cluster.serve(w, max_wall_s=300)
        assert m["completed"] == 3
    finally:
        shutil.rmtree(d)


def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys):
    """``launch.train --device cpu`` prints the reference's record with a
    finite loss that falls; a second call resumes from its checkpoint."""
    from repro_torch.launch import train
    args = ["--arch", "qwen2.5-3b", "--steps", "10", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    train.main(args)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"arch", "steps", "first_loss", "last_loss",
                        "straggler_events"}
    assert rec["steps"] == 10 and rec["arch"] == "qwen2.5-3b-smoke"
    assert np.isfinite(rec["last_loss"])
    assert rec["last_loss"] < rec["first_loss"]
    tr = train.main(args[:3] + ["12"] + args[4:])
    out = capsys.readouterr().out
    assert "from step 10 -> 12" in out and tr.step == 12
