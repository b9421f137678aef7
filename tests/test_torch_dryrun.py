"""The port's dry run (``repro_torch.launch.dryrun``) and its abstract
trees, on the CPU.

- ``abstract_params`` / ``abstract_cache`` give the reference's
  ``eval_shape`` trees (the port's block leaves per layer: the stacked
  shape without its lead dim), dtype for dtype, on the meta device: no
  storage, kimi-k2's trillion parameters included;
- ``DeviceCounter``, the per-device memory, FLOP and collective count, is
  held to a hand count of a small DTensor program on a fake 2x2 mesh;
- ``run_cell`` runs smoke configurations of every family (dense, MoE with
  Adafactor, RWKV-6, hybrid, vision) on a fake 2x4 mesh: every cell ``ok``
  with the reference's record keys, and argument bytes equal to the
  reference's (its own ``build_cell`` on a JAX ``AbstractMesh`` of the
  same shape, the shard shape of every argument leaf summed);
- the argument bytes ``chip_smoke.py`` phase 33 holds the card machine's
  dry run to are the reference's for those six production cells.

The cells and the hand count run in a subprocess: a process keeps its
default process group (the dry run's fake one of 512 ranks), and no test
worker should.
"""
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import get_config as rget_config
from repro.configs import get_smoke_config as rget_smoke
from repro.models import transformer as RT
from repro.models.config import ShapeConfig as RShape
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's record keys (repro/launch/dryrun.py run_cell)
REF_KEYS = {"arch", "shape", "mesh", "kind", "variant", "status", "fsdp",
            "compile_s", "memory", "cost_analysis", "collectives",
            "hlo_bytes", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_per_device"}
ROOFLINE_KEYS = {"hlo_flops", "model_flops", "hbm_bytes_per_chip",
                 "collective_bytes_per_chip", "compute_s", "memory_s",
                 "collective_s", "dominant", "step_s", "roofline_fraction",
                 "flops_ratio"}


def _reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS for 512 host devices when
    imported (this process's JAX is up already): the variable is put back
    so no later subprocess inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as RD
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return RD


def _rflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_match_reference_and_allocate_nothing(arch):
    cfg = get_config(arch).replace(pad_heads_to=16)
    rcfg = rget_config(arch).replace(pad_heads_to=16)
    t0 = time.perf_counter()
    params = T.abstract_params(cfg)
    seconds = time.perf_counter() - t0
    ref = _rflat(RT.abstract_params(rcfg))
    seen = set()
    for key, leaf in flatten_with_paths(params):
        assert leaf.device.type == "meta", key
        parts = key.split("/")
        if parts[0] == "blocks":
            rkey = "/".join(["blocks"] + parts[2:])
            want = tuple(ref[rkey].shape[1:])
        else:
            rkey, want = key, tuple(ref[key].shape)
        assert tuple(leaf.shape) == want, key
        assert _dtype(leaf.dtype) == str(ref[rkey].dtype), key
        seen.add(rkey)
    assert seen == set(ref)
    assert len(params["blocks"]) == cfg.num_layers
    assert seconds < 10, seconds            # kimi-k2: 1.04e12 parameters
    for B, C in ((128, 32768), (1, 524288)):
        cache = dict(flatten_with_paths(T.abstract_cache(cfg, B, C)))
        rcache = _rflat(RT.abstract_cache(rcfg, B, C))
        assert set(cache) == set(rcache)
        for k, leaf in cache.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(rcache[k].shape), k
            assert _dtype(leaf.dtype) == str(rcache[k].dtype), k


# ---------------------------------------------------------------------------
# the subprocess: hand count and smoke cells

SMOKE_MESH = ((2, 4), ("data", "model"))
# (arch, shape name, seq_len, global batch, kind)
SMOKE_CELLS = [(a, k, S, B, kind)
               for a in ("qwen2.5-3b", "granite-moe-1b-a400m",
                         "kimi-k2-1t-a32b", "rwkv6-1.6b", "hymba-1.5b",
                         "llava-next-34b")
               for k, S, B, kind in (("prefill", 64, 4, "prefill"),
                                     ("decode", 64, 8, "decode"),
                                     ("train", 32, 4, "train"))] + [
    ("rwkv6-1.6b", "long", 256, 1, "decode"),
    ("hymba-1.5b", "long", 256, 1, "decode")]

_CHILD = r"""
import json, sys, tempfile, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models.config import ShapeConfig

out = {}
# the hand count: a 2x2 mesh, meta shards
mesh = make_fake_mesh((2, 2), ("data", "model"))
x = DTensor.from_local(torch.empty(4, 16, device="meta"), mesh,
                       (Replicate(), Shard(0)), run_check=False)
w = DTensor.from_local(torch.empty(16, 8, device="meta"), mesh,
                       (Replicate(), Replicate()), run_check=False)
c = D.DeviceCounter()
c.exclude((x, w))
with c:
    h = x @ w                               # [4, 8] fp32 local: 128 B
    g = h.redistribute(mesh, (Replicate(), Replicate()))   # gather: 256 B
    del h
    y = torch.relu(g)                       # 256 B
    del g
out["hand"] = {"peak": c.peak, "live": c.live, "flops": c.flops,
               "collectives": c.collectives}

mesh = make_fake_mesh(*json.loads(sys.argv[1]))
recs = []
with tempfile.TemporaryDirectory() as tmp:
    for arch, name, S, B, kind in json.loads(sys.argv[2]):
        cfg = get_smoke_config(arch).replace(pad_heads_to=4)
        recs.append(D.run_cell(arch, name, "small", tmp, force=True, cfg=cfg,
                               shape=ShapeConfig(name, S, B, kind),
                               mesh=mesh))
out["cells"] = recs
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(SMOKE_MESH),
                        json.dumps(SMOKE_CELLS)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_device_counter_holds_to_a_hand_count(child):
    """x [8,16] fp32 split in row halves over the model axis (local
    [4,16]), w [16,8] replicated: ``x @ w`` allocates the local [4,8]
    (128 B, 2*4*16*8 = 1,024 FLOPs); gathering it over the model axis
    allocates [8,8] (256 B: one all-gather of 256 result bytes) while the
    shard is alive (384 B); the shard is dropped (256); ``relu`` allocates
    another 256 B beside the gathered copy (512 B, the peak) and the copy
    is dropped: 256 B live at the end. The arguments are not counted."""
    hand = child["hand"]
    assert hand["flops"] == 1024
    assert hand["peak"] == 512 and hand["live"] == 256, hand
    assert hand["collectives"] == {"all-gather": {"count": 1, "bytes": 256}}


def _ref_argument_bytes(RD, rcfg, rshape, mesh):
    _, args, _ = RD.build_cell(rcfg, rshape, mesh)
    # a train step's step counter carries no sharding: one int32 each
    return sum(math.prod(a.sharding.shard_shape(a.shape) if a.sharding
                         else a.shape) * a.dtype.itemsize
               for a in jax.tree_util.tree_leaves(args))


def _prefill_peak(cfg, B, S, impl):
    """The live-byte peak of ``prefill_full`` on meta parameters and
    tokens (no mesh: the counter sees plain meta tensors), and the
    cache's bytes."""
    from repro_torch.launch import dryrun as D
    params = T.abstract_params(cfg)
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    c = D.DeviceCounter()
    c.exclude(params)
    with c:
        _, cache = T.prefill_full(params, cfg, {"tokens": toks}, impl=impl)
    return c.peak, sum(t.nbytes for k, t in cache.items() if k != "pos")


def test_dry_run_prefill_holds_no_score_tensor():
    """The dry run traces the reference's lowering (``impl="xla"``): a
    prompt attends by the blocked online softmax, block 1024, so its peak
    stays far below one S x S fp32 score tensor (1 GiB at 4 heads over
    8,192 positions; 0.26 of it here), which the kernel's plain version
    builds (2.0 of it)."""
    cfg = get_smoke_config("qwen2.5-3b")
    B, S = 1, 8192
    peak, _ = _prefill_peak(cfg, B, S, "xla")
    assert peak < 0.5 * B * cfg.padded_heads * S * S * 4, peak


def test_prefill_holds_its_cache_once():
    """Each layer's K/V is written into one stacked cache as it is made
    (the reference's scan writes its stacked output in place), so the
    peak stays below 1.5 caches (1.29 here), where stacking the layers'
    list at the end held two. 64 layers of 4 KV heads of 64 over 4 x 256
    tokens: the cache (64 MiB) outweighs a layer's activations."""
    cfg = get_smoke_config("qwen2.5-3b").replace(num_layers=64,
                                                 num_kv_heads=4, head_dim=64)
    peak, cache = _prefill_peak(cfg, 4, 256, "xla")
    assert cache == 64 * 2 * 4 * 256 * 4 * 64 * 2
    assert peak < 1.5 * cache, (peak, cache)


@pytest.mark.parametrize("cell", SMOKE_CELLS,
                         ids=[f"{a}-{n}" for a, n, *_ in SMOKE_CELLS])
def test_run_cell_smoke_families_on_a_fake_mesh(child, cell):
    arch, name, S, B, kind = cell
    rec = next(r for r in child["cells"]
               if r["arch"] == arch and r["shape"] == name)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == REF_KEYS, set(rec) ^ REF_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["hlo_bytes"] is None and rec["cost_analysis"]["flops"] > 0
    mem = rec["memory"]
    assert mem["peak_per_device"] == (mem["argument_bytes"]
                                      + mem["temp_bytes"]
                                      + mem["output_bytes"]
                                      - mem["alias_bytes"])
    assert mem["temp_bytes"] >= 0
    if kind == "decode":        # the cache is updated in place
        assert mem["alias_bytes"] > 0
    RD = _reference_dryrun()
    rcfg = rget_smoke(arch).replace(pad_heads_to=4)
    want = _ref_argument_bytes(RD, rcfg, RShape(name, S, B, kind),
                               JMesh(*SMOKE_MESH))
    assert mem["argument_bytes"] == want, (mem["argument_bytes"], want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase33_argument_bytes_are_the_references():
    """``chip_smoke.py`` phase 33 fails unless the card machine's dry run
    of six production cells gives these argument bytes: the reference's
    own ``build_cell`` on the 16x16 mesh gives them."""
    RD = _reference_dryrun()
    want = _chip_smoke().DRYRUN_ARG_BYTES
    mesh = JMesh((16, 16), ("data", "model"))
    assert len(want) == 6
    for (arch, shape_name, variant), n in want.items():
        rcfg = rget_config(arch).replace(pad_heads_to=16,
                                         **RD.VARIANTS[variant])
        s = RD.get_shape(shape_name)
        assert _ref_argument_bytes(RD, rcfg, s, mesh) == n, (arch, n)


_REFERENCE_CELL = r"""
import json, sys, tempfile, jax
from jax.sharding import AxisType
import repro.launch.dryrun as RD

def make_production_mesh(*, multi_pod=False):
    # the reference's meshes with Auto axes: jax.make_mesh's default axis
    # type is Explicit in this JAX, under which the reference's sharding
    # constraints do not lower (ShardingTypeError at its first cell)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

RD.make_production_mesh = make_production_mesh
with tempfile.TemporaryDirectory() as tmp:
    print(json.dumps(RD.run_cell(sys.argv[1], sys.argv[2], "single", tmp)))
"""


def test_decode_cell_beside_the_reference_dry_run(tmp_path):
    """qwen2.5-3b decode_32k on the 16x16 mesh through both dry runs: the
    reference's compiled by XLA on 512 host devices, the port's traced on
    the fake group. Argument bytes are equal; the rest is printed side by
    side (run with -s): XLA counts a scan body's collectives once and
    keeps a layer scan's carried cache beside the donated one, the port
    counts every layer's and updates the cache in place."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_CELL, "qwen2.5-3b",
                          "decode_32k"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-4000:]
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "single", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True, timeout=600)
    assert port.returncode == 0, port.stderr[-4000:]
    r = json.loads(ref.stdout.strip().splitlines()[-1])
    p = json.loads((tmp_path / "qwen2.5-3b__decode_32k__single.json")
                   .read_text())
    assert r["status"] == p["status"] == "ok"
    assert p["memory"]["argument_bytes"] == r["memory"]["argument_bytes"]
    for what in ("memory", "collectives", "cost_analysis"):
        print(f"{what}: reference {json.dumps(r[what], sort_keys=True)}")
        print(f"{what}: port      {json.dumps(p[what], sort_keys=True)}")
