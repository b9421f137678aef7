"""The port's sharded model on four CPU ranks (gloo), against the port
unsharded and against the JAX package's own sharded run.

Four processes form a 2x2 ``("data","model")`` mesh of the gloo backend
(a ``DeviceMesh`` over ``torch.distributed``'s world, spawned by this file
run as a script; ``launch.mesh.make_host_mesh`` gives a world of one its
mesh in a test of its own). On it the
smoke configurations of the dense (qwen2.5), MoE (granite), RWKV-6 and
hybrid (hymba) families run ``prefill_full`` and then ``decode_step``
under ``use_mesh``, in float32, on DTensor parameters laid out by
``specs.distribute_params`` from weights converted from the JAX package's
(``convert.from_reference``); the prefill's cache is laid out as
``specs.cache_shardings`` says before decoding (the dense cache's sequence
split over the model axis: the context-parallel decode). One train step's
loss and grads (FSDP on) run there too.

- dense, RWKV and hybrid logits, and the train step's loss and grads,
  equal the port's unsharded run within 1e-5 of their scale (float32;
  only the order of additions differs);
- the MoE FFN under a mesh is the reference's ``shard_map`` (capacity per
  data shard) or ``expert_tp`` branch, which differ from an unsharded run
  by design: both branches, the FFN alone (output and metrics, the same
  dropped count) and the whole prefill and decode, equal the JAX
  package's run on a 2x2 host mesh (``XLA_FLAGS`` forcing 4 CPU devices,
  in a subprocess) within 1e-5 of scale.

The ranks write what they computed to a temporary directory, which the
tests read; the whole run takes about a minute on this host.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-5
B, S, CAP, STEPS = 2, 12, 16, 2
GRANITE = "granite-moe-1b-a400m"
# (name, arch, options): fsdp lays the weights' other dim over the data
# axis too; etp is granite's expert_tp branch
CASES = [("dense", "qwen2.5-3b", {}),
         ("dense_fsdp", "qwen2.5-3b", {"fsdp": True}),
         ("rwkv", "rwkv6-1.6b", {}),
         ("hybrid", "hymba-1.5b", {"S": 20}),
         ("moe", GRANITE, {}),
         ("moe_etp", GRANITE, {"etp": True})]


def _cfg(arch, etp=False):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(dtype="float32",
                                          moe_expert_tp=etp)


def _tokens(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=n).astype(np.int64)


# ---------------------------------------------------------------------------
# the ranks


def _rank_main(rank, port, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.parallel import specs as SP
    from repro_torch.parallel.sharding import placements_for, use_mesh
    from repro_torch.train.train_step import loss_and_grad
    from repro_torch.tree import flatten_with_paths

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    # 2x2, where the reference's host rule would give 1x4
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    out = {}

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def batch(t):
        with use_mesh(mesh):
            pl = placements_for(t.shape, "dp", *(None,) * (t.dim() - 1))
        return distribute_tensor(t, mesh, pl)

    for name, arch, opt in CASES:
        cfg = _cfg(arch, opt.get("etp", False))
        params = torch.load(os.path.join(tmp, f"{arch}.pt"))
        dp = SP.distribute_params(params, cfg, mesh,
                                  fsdp=opt.get("fsdp", False),
                                  expert_tp=opt.get("etp", False))
        toks = torch.from_numpy(_tokens(cfg.vocab_size, B * opt.get("S", S),
                                        1)).reshape(B, -1)
        steps = torch.from_numpy(_tokens(cfg.vocab_size, B * STEPS, 2)
                                 ).reshape(STEPS, B)
        with torch.no_grad(), use_mesh(mesh, fsdp=opt.get("fsdp", False)):
            logits, cache = T.prefill_full(dp, cfg, {"tokens": batch(toks)},
                                           capacity=CAP, impl="plain")
            out[f"{name}/prefill"] = full(logits)
            # the server's layout: specs.cache_shardings
            sh = dict(flatten_with_paths(SP.cache_shardings(cfg, cache, mesh,
                                                            B)))
            cache = {k: v.redistribute(mesh, sh[k].placements)
                     if isinstance(v, DTensor) else v
                     for k, v in cache.items()}
            out[f"{name}/cache_placements"] = {
                k: str(tuple(v.placements)) for k, v in cache.items()
                if isinstance(v, DTensor)}
            for i in range(STEPS):
                logits, cache = T.decode_step(dp, cfg, cache, batch(steps[i]),
                                              impl="plain")
                out[f"{name}/decode{i}"] = full(logits)
        with torch.no_grad(), use_mesh(mesh):
            if cfg.moe is not None:
                x = torch.from_numpy(np.random.default_rng(3).normal(
                    size=(B, S, cfg.d_model)).astype(np.float32))
                y, aux = M.moe_ffn(batch(x), dp["blocks"][0]["moe"], cfg.moe,
                                   expert_tp=cfg.moe_expert_tp)
                out[f"{name}/moe_y"] = full(y)
                for k, v in aux.items():
                    out[f"{name}/{k}"] = full(v)

    # one train step's loss and grads, FSDP on, as the dry run's train cells
    cfg = _cfg("qwen2.5-3b")
    params = torch.load(os.path.join(tmp, "qwen2.5-3b.pt"))
    dp = SP.distribute_params(params, cfg, mesh, fsdp=True)
    tb = {k: torch.from_numpy(_tokens(cfg.vocab_size, 4 * 16, seed)
                              ).reshape(4, 16) for k, seed in
          (("tokens", 4), ("labels", 5))}
    with use_mesh(mesh, fsdp=True):
        loss, _, grads = loss_and_grad(dp, cfg, {k: batch(v)
                                                 for k, v in tb.items()})
    out["train/loss"] = full(loss)
    for k, g in flatten_with_paths(grads):
        out[f"train/grad/{k}"] = full(g)

    if rank == 0:
        torch.save(out, os.path.join(tmp, "sharded.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the JAX package on a 2x2 host mesh (its own process: 4 CPU devices)

_REFERENCE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import moe as RM, transformer as RT
from repro.parallel.sharding import use_mesh
B, S, CAP, STEPS, tmp = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]), sys.argv[5])
toks, steps, x = (np.load(f"{tmp}/{k}.npy") for k in ("toks", "steps", "x"))
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
out = {}
for name, etp in (("moe", False), ("moe_etp", True)):
    cfg = get_smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32", moe_expert_tp=etp)
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    with use_mesh(mesh):
        logits, cache = jax.jit(lambda p, t: RT.prefill_full(
            p, cfg, {"tokens": t}, capacity=CAP))(params, toks)
        out[f"{name}/prefill"] = logits
        step = jax.jit(lambda p, c, t: RT.decode_step(p, cfg, c, t))
        for i in range(STEPS):
            logits, cache = step(params, cache, steps[i])
            out[f"{name}/decode{i}"] = logits
        moe_p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
        y, aux = jax.jit(lambda xx, mp: RM.moe_ffn(
            xx, mp, cfg.moe, expert_tp=etp))(x, moe_p)
        out[f"{name}/moe_y"] = y
        for k, v in aux.items():
            out[f"{name}/{k}"] = v
np.savez(f"{tmp}/reference.npz", **{k: np.asarray(v, np.float32)
                                     for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded ranks' outputs, the port's unsharded ones and the JAX
    package's sharded ones, from the same weights and tokens."""
    import jax

    from repro.configs import get_smoke_config as rget_smoke
    from repro.models import transformer as RT
    from repro_torch.convert import from_reference
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import loss_and_grad
    from repro_torch.tree import flatten_with_paths

    tmp = tmp_path_factory.mktemp("parallel")
    for arch in {a for _, a, _ in CASES}:
        rparams = RT.init_params(rget_smoke(arch).replace(dtype="float32"),
                                 jax.random.PRNGKey(0))
        torch.save(from_reference(jax.tree.map(np.asarray, rparams),
                                  device="cpu"), tmp / f"{arch}.pt")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    sharded = subprocess.run(
        [sys.executable, __file__, str(tmp), str(_free_port())], env=env,
        capture_output=True, text=True, timeout=600)
    assert sharded.returncode == 0, sharded.stderr[-4000:]

    cfg = _cfg(GRANITE)
    np.save(tmp / "toks.npy", _tokens(cfg.vocab_size, B * S, 1).reshape(B, -1)
            .astype(np.int32))
    np.save(tmp / "steps.npy", _tokens(cfg.vocab_size, B * STEPS, 2)
            .reshape(STEPS, B).astype(np.int32))
    np.save(tmp / "x.npy", np.random.default_rng(3).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(B), str(S), str(CAP),
         str(STEPS), str(tmp)],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-4000:]

    plain = {}
    for name, arch, opt in CASES:
        cfg = _cfg(arch, opt.get("etp", False))
        params = torch.load(tmp / f"{arch}.pt")
        toks = torch.from_numpy(_tokens(cfg.vocab_size, B * opt.get("S", S),
                                        1)).reshape(B, -1)
        steps = torch.from_numpy(_tokens(cfg.vocab_size, B * STEPS, 2)
                                 ).reshape(STEPS, B)
        with torch.no_grad():
            logits, cache = T.prefill_full(params, cfg, {"tokens": toks},
                                           capacity=CAP, impl="plain")
            plain[f"{name}/prefill"] = logits
            for i in range(STEPS):
                logits, cache = T.decode_step(params, cfg, cache, steps[i],
                                              impl="plain")
                plain[f"{name}/decode{i}"] = logits
    cfg = _cfg("qwen2.5-3b")
    tb = {k: torch.from_numpy(_tokens(cfg.vocab_size, 4 * 16, seed)
                              ).reshape(4, 16) for k, seed in
          (("tokens", 4), ("labels", 5))}
    loss, _, grads = loss_and_grad(torch.load(tmp / "qwen2.5-3b.pt"), cfg,
                                   tb)
    plain["train/loss"] = loss
    for k, g in flatten_with_paths(grads):
        plain[f"train/grad/{k}"] = g
    return {"sharded": torch.load(tmp / "sharded.pt"), "plain": plain,
            "reference": dict(np.load(tmp / "reference.npz"))}


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("name", ["dense", "dense_fsdp", "rwkv", "hybrid"])
def test_sharded_prefill_and_decode_equal_unsharded(runs, name):
    """Dense, RWKV and hybrid: the logits of the prefill and of every
    decode step on the 2x2 mesh equal the port's unsharded run."""
    keys = [f"{name}/prefill"] + [f"{name}/decode{i}" for i in range(STEPS)]
    for k in keys:
        _close(runs["sharded"][k], runs["plain"][k], k)


def test_dense_decode_ran_context_parallel(runs):
    """qwen2.5's smoke configuration has one KV head, which the model axis
    cannot split: its cache was split over the sequence, as the
    reference's specs say, so the decode steps above merged partial
    softmaxes across the model axis."""
    pl = runs["sharded"]["dense/cache_placements"]
    assert pl["k"] == pl["v"] == "(Shard(dim=1), Shard(dim=2))", pl


@pytest.mark.parametrize("name", ["moe", "moe_etp"])
def test_moe_branches_equal_reference_shard_map(runs, name):
    """granite's MoE under the mesh, each of the reference's two branches:
    the FFN alone (output, aux and z losses, the same dropped count) and
    the whole prefill and decode, against the JAX package's run on a 2x2
    mesh."""
    got, want = runs["sharded"], runs["reference"]
    for k in ([f"{name}/prefill", f"{name}/moe_y", f"{name}/moe_aux_loss",
               f"{name}/moe_z_loss"]
              + [f"{name}/decode{i}" for i in range(STEPS)]):
        _close(got[k], want[k], k)
    assert float(got[f"{name}/moe_dropped"]) == \
        float(want[f"{name}/moe_dropped"]), name


def test_moe_shard_map_differs_from_unsharded_by_design(runs):
    """Capacity per data shard: the sharded MoE's logits need not equal an
    unsharded run; they are held to the reference's sharded run above.
    Here: both are finite and of one shape."""
    a, b = runs["sharded"]["moe/prefill"], runs["plain"]["moe/prefill"]
    assert a.shape == b.shape and torch.isfinite(a).all()


def test_sharded_train_step_equals_unsharded(runs):
    """One train step's loss and every grad, FSDP on (the dry run's train
    layout), against the unsharded step."""
    got, want = runs["sharded"], runs["plain"]
    _close(got["train/loss"], want["train/loss"], "loss")
    grads = [k for k in want if k.startswith("train/grad/")]
    assert len(grads) > 10
    for k in grads:
        _close(got[k], want[k], k)


_ONE_RANK = r"""
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import placements_for, use_mesh
from repro_torch.parallel.specs import distribute_params
mesh = make_host_mesh()
for dtype in ("float32", "bfloat16"):
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype=dtype)
    params = T.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want, _ = T.prefill_full(params, cfg, {"tokens": toks}, impl="plain")
        with use_mesh(mesh):
            dt = distribute_tensor(toks, mesh,
                                   placements_for(toks.shape, "dp", None))
            got, _ = T.prefill_full(distribute_params(params, cfg, mesh), cfg,
                                    {"tokens": dt}, impl="plain")
    assert torch.equal(got.full_tensor(), want), dtype
print(tuple(mesh.mesh.shape), dist.get_world_size())
dist.destroy_process_group()
"""


def test_one_rank_mesh_prefill_is_bit_equal():
    """``make_host_mesh`` on a world of one (its own gloo rank here, NCCL
    on a card, as ``chip_smoke.py`` phase 34 runs it): every placement
    replicates, so the plain prefill on DTensor parameters gives the
    logits of the plain prefill without a mesh bit for bit, in float32
    and bf16."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _ONE_RANK], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.split()[-3:] == ["(1,", "1)", "1"], r.stdout


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(int(sys.argv[2]), sys.argv[1]),
             nprocs=WORLD, join=True)
