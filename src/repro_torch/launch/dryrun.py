"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the
production meshes, on the host, and count what one device would hold, do
and send.

The port's counterpart of ``repro.launch.dryrun``. It is a host-only
program: it never touches a card (or needs one). For each cell it

  1. builds abstract params / optimizer state / inputs / caches on the
     meta device (``transformer.abstract_params``/``abstract_cache``: no
     storage, even for kimi-k2's trillion parameters);
  2. lays them out as DTensors on the 16x16 or 2x16x16 mesh
     (``launch.mesh``: a fake process group of 512 ranks), per
     ``parallel.specs``: each device's shard is a meta tensor of its local
     shape (a fake tensor's shape-only execution without its bookkeeping,
     which made the RWKV chunk loop 4.7x slower);
  3. runs the reference's step with ``impl="xla"`` under ``use_mesh``
     (``prefill_full``, the dense ``decode_step``, or ``make_train_step``
     with ``make_optimizer(cfg.optimizer)``): the reference's own default
     lowering and no kernel, so a prompt attends by the blocked online
     softmax, never a whole score tensor;
  4. records, per device (rank 0's shards; the specs divide every dim
     they shard, so every rank holds the same shapes):
       - ``memory``: argument bytes (the local shards of params, state,
         inputs and cache), output bytes, alias bytes (outputs that are
         arguments updated in place), and the peak of live local bytes
         across the step (``DeviceCounter``); temp bytes are the peak less
         arguments and the step's new outputs, so ``peak_per_device =
         argument + temp + output - alias`` as in the reference;
       - ``cost_analysis.flops``: the FLOPs of the local products (the
         whole step; XLA's ``cost_analysis`` counts a scan body once);
       - ``collectives``: the collectives DTensor issued, folded into the
         reference's five kinds, with count and result bytes;
       - ``roofline``: ``core/roofline.py``'s closed forms, the
         reference's, which price a TPU v5e;
  5. writes one JSON per cell under ``results/dryrun_torch/`` (resumable).

The records keep the reference's keys. Those the port cannot fill are
null: ``hlo_bytes`` (there is no HLO), ``cost_analysis`` "bytes accessed"
and "transcendentals" (XLA's fusion-level counts). ``compile_s`` holds the
trace seconds. Collective counts differ from XLA's by construction:
DTensor redistributes op by op where GSPMD partitions the whole program.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.roofline import (MULTI_POD, SINGLE_POD, Overrides,
                                       cell_roofline)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.frontends import input_specs
from repro_torch.parallel import specs as SP
from repro_torch.parallel.sharding import mesh_shape, use_mesh
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_with_paths, unflatten_like

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# torch's functional collectives -> the reference's HLO collective kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# collective wrappers that hand back their input's buffer on a device
_ALIASING = ("wait_tensor", "_wrap_tensor_autograd")


def _storages(tree):
    """{id: storage} of the local tensors of a tree's leaves (a DTensor's
    local shard)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st
    return out


def _nbytes(storages) -> int:
    return sum(st.nbytes() for st in storages.values())


class DeviceCounter(TorchDispatchMode):
    """Counts one device's side of a DTensor program: the live bytes of
    the local tensors its ops allocate (and their peak), the FLOPs of its
    local products, and the collectives it issues.

    It sits beneath DTensor: an op on DTensors is passed on
    (``NotImplemented``), and DTensor's local ops -- the shards' compute,
    the collectives' buffers -- come back through it on plain (meta)
    tensors. Memory is counted per storage, from its first appearance to
    its release, so views and in-place updates cost nothing; storages that
    exist before the count (``exclude``) are never counted. The ops DTensor
    runs on *global* shapes to propagate its metadata are skipped."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.flops = 0
        self.collectives = {}
        self._known = {}        # id(storage) -> (weakref, counted bytes)
        self._skip = 0

    def exclude(self, tree) -> None:
        """Mark the storages of ``tree`` as not this count's (arguments)."""
        for key, st in _storages(tree).items():
            self._known[key] = (weakref.ref(st), 0)

    def _release(self, key):
        self.live -= self._known.pop(key, (None, 0))[1]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known and self._known[key][0]() is st:
            return
        n = st.nbytes()
        self._known[key] = (weakref.ref(st, lambda _, k=key: self._release(k)),
                            n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _alias(self, out: torch.Tensor, src: torch.Tensor) -> None:
        """``out`` is ``src``'s buffer on a device (the meta kernel of the
        op makes a new one): its storage takes over ``src``'s count."""
        n = self._known.pop(id(src.untyped_storage()), (None, 0))[1]
        st = out.untyped_storage()
        key = id(st)
        self._known[key] = (weakref.ref(st, lambda _, k=key: self._release(k)),
                            n)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._prop = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop_self, op_schema):
            counter._skip += 1
            try:
                return counter._prop(prop_self, op_schema)
            finally:
                counter._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._skip:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _COLLECTIVES.get(packet.__name__)
        if kind is not None and "c10d" in func.namespace:
            nbytes = sum(t.untyped_storage().nbytes() for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += nbytes
        if packet.__name__ in _ALIASING and isinstance(out, torch.Tensor):
            self._alias(out, args[0])
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def serve_needs_fsdp(cfg: ModelConfig, mesh_model: int = 16) -> bool:
    """Weight-gathered serving when model-axis sharding alone overflows the
    reference chip's HBM (``TPU_V5E``, as the reference decides)."""
    return cfg.param_count() * 2 / mesh_model > 0.45 * TPU_V5E.hbm_cap


# the reference's hillclimb variants: named sets of config/layout overrides
VARIANTS = {
    "base": {},
    "kvq": {"kv_quant": True},
    "etp": {"moe_expert_tp": True},
    "kvq+etp": {"kv_quant": True, "moe_expert_tp": True},
    "bf16psum": {"moe_combine_fp32": False},
    "noremat": {"remat": False},
    "bf16psum+noremat": {"moe_combine_fp32": False, "remat": False},
    "accum4": {"grad_accum": 4},
    "expand": {"grouped_decode": False},
    "bf16psum+noremat+accum16": {"moe_combine_fp32": False, "remat": False,
                                 "grad_accum": 16},
    "grouped+kvq": {"kv_quant": True},
    "expand+kvq": {"grouped_decode": False, "kv_quant": True},
}


def _contiguous_stride(shape):
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def _shard(tree, shardings):
    """Abstract leaves -> DTensors whose local shards are meta tensors of
    the shard shape."""
    out = []
    for (_, leaf), (_, s) in zip(flatten_with_paths(tree),
                                 flatten_with_paths(shardings)):
        shape = tuple(leaf.shape)
        local = torch.empty(s.shard_shape(shape), dtype=leaf.dtype,
                            device="meta")
        out.append(DTensor.from_local(local, s.mesh, s.placements,
                                      run_check=False, shape=shape,
                                      stride=_contiguous_stride(shape)))
    return unflatten_like(tree, out)


def _dp_size(mesh) -> int:
    return math.prod(n for a, n in mesh_shape(mesh).items()
                     if a in ("pod", "data"))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Returns (fn, args, fsdp): ``fn(*args)`` runs the cell's step on
    DTensor arguments of meta shards, under ``use_mesh(mesh, fsdp=fsdp)``
    (the one place the cell's FSDP is decided)."""
    expert_tp = cfg.moe_expert_tp and shape.kind != "train"
    fsdp = shape.kind == "train" or (serve_needs_fsdp(cfg) and not expert_tp)
    params_abs = T.abstract_params(cfg)
    params_sh = SP.params_shardings(cfg, params_abs, mesh, fsdp=fsdp,
                                    expert_tp=expert_tp)
    params = _shard(params_abs, params_sh)

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        step_fn = make_train_step(cfg, opt)
        opt_abs = opt.init(params_abs)
        opt_sh = SP.opt_state_shardings(params_sh, opt_abs, mesh)
        opt_state = _shard(opt_abs, opt_sh)
        batch_abs = dict(input_specs(cfg, shape))
        batch = _shard(batch_abs, SP.batch_shardings(batch_abs, mesh))
        step = torch.zeros((), dtype=torch.int32, device="meta")
        return step_fn, (params, opt_state, batch, step), fsdp

    if shape.kind == "prefill":
        inputs_abs = dict(input_specs(cfg, shape))
        inputs = _shard(inputs_abs, SP.batch_shardings(inputs_abs, mesh))
        fn = lambda p, i: T.prefill_full(p, cfg, i, impl="xla")  # noqa: E731
        return fn, (params, inputs), fsdp

    # decode
    B, S = shape.global_batch, shape.seq_len
    cache_abs = T.abstract_cache(cfg, B, S)
    cache = _shard(cache_abs, SP.cache_shardings(cfg, cache_abs, mesh, B))
    tok_abs = {"tokens": torch.empty((B,), dtype=torch.int32, device="meta")}
    tok_sh = SP.batch_shardings(tok_abs, mesh,
                                batch_shardable=(B % _dp_size(mesh) == 0))
    tokens = _shard(tok_abs, tok_sh)["tokens"]
    fn = lambda p, c, t: T.decode_step(p, cfg, c, t, impl="xla")  # noqa: E731
    return fn, (params, cache, tokens), fsdp


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Build and run one cell on ``mesh``; returns (fsdp, memory dict,
    flops, collectives)."""
    counter = DeviceCounter()
    fn, args, fsdp = build_cell(cfg, shape, mesh)
    with use_mesh(mesh, fsdp=fsdp):
        arg_st = _storages(args)
        counter.exclude(args)
        with counter:
            out = fn(*args)
        out_st = _storages(out)
    alias = {k: st for k, st in out_st.items() if k in arg_st}
    arg_b, out_b, alias_b = _nbytes(arg_st), _nbytes(out_st), _nbytes(alias)
    temp_b = counter.peak - (out_b - alias_b)
    memory = {"argument_bytes": arg_b, "output_bytes": out_b,
              "temp_bytes": temp_b, "alias_bytes": alias_b,
              # per device: rank 0's local shards
              "peak_per_device": arg_b + temp_b + out_b - alias_b}
    return fsdp, memory, counter.flops, counter.collectives


def _overrides(cfg: ModelConfig, shape: ShapeConfig) -> Overrides:
    """The roofline's overrides mirroring the cell's configuration, as the
    reference derives them."""
    return Overrides(
        remat=cfg.remat,
        moe_combine_fp32=cfg.moe_combine_fp32,
        kv_bytes_elem=(1.0 + 2.0 / cfg.dh) if cfg.kv_quant else 2.0,
        decode_grouped=bool(cfg.grouped_decode and cfg.can_group_decode),
        serve_fsdp=bool(serve_needs_fsdp(cfg)
                        and not (cfg.moe_expert_tp)
                        and shape.kind != "train"),
    )


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, variant: str = "base", *,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None, mesh=None):
    """One cell's record, written to ``out_dir`` (and read back from there
    unless ``force``). ``cfg``, ``shape`` and ``mesh`` replace the
    registry's configuration (with the variant's overrides), the named
    shape and the production mesh of ``mesh_kind``: smaller cells for
    tests and for holding a prediction against a card."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    if variant != "base":
        tag += f"__{variant}"
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        print(f"[skip existing] {tag}")
        with open(out_path) as f:
            return json.load(f)

    if cfg is None:
        cfg = get_config(arch).replace(pad_heads_to=16,  # model-axis multiple
                                       **VARIANTS[variant])
    shape = shape or get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "variant": variant, "status": "error"}
    t0 = time.time()
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        fsdp, memory, flops, coll = trace_cell(cfg, shape, mesh)
        rec.update({
            "status": "ok",
            "fsdp": fsdp,
            "compile_s": round(time.time() - t0, 1),
            "memory": memory,
            "cost_analysis": {"flops": flops, "bytes accessed": None,
                              "transcendentals": None},
            "collectives": coll,
            "hlo_bytes": None,
        })
        # analytic roofline (single-pod basis; see core/roofline.py), with
        # overrides mirroring this variant's configuration
        rt = cell_roofline(cfg, shape,
                           SINGLE_POD if mesh_kind == "single" else MULTI_POD,
                           _overrides(cfg, shape))
        rec["roofline"] = {
            "hlo_flops": rt.hlo_flops, "model_flops": rt.model_flops,
            "hbm_bytes_per_chip": rt.hbm_bytes_per_chip,
            "collective_bytes_per_chip": rt.collective_bytes_per_chip,
            "compute_s": rt.compute_s, "memory_s": rt.memory_s,
            "collective_s": rt.collective_s, "dominant": rt.dominant,
            "step_s": rt.step_s,
            "roofline_fraction": rt.roofline_fraction,
            "flops_ratio": rt.flops_ratio,
        }
        print(f"[ok {rec['compile_s']:7.1f}s] {tag} "
              f"peak/dev={memory['peak_per_device']/2**30:.2f}GiB "
              f"dominant={rt.dominant} frac={rt.roofline_fraction:.3f}")
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["compile_s"] = round(time.time() - t0, 1)
        print(f"[FAIL {rec['compile_s']:6.1f}s] {tag}: {rec['error'][:200]}")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", choices=list(VARIANTS), default="base")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)
    # DTensor warns at every redistribution it makes in several
    # collectives: the records count them
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    if args.all:
        for arch, shape_name, runnable, why in cells(include_skips=True):
            if not runnable:
                print(f"[skip cell] {arch}/{shape_name}: {why}")
                continue
            todo += [(arch, shape_name, m) for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape, m) for m in meshes]

    ok = fail = 0
    for arch, shape_name, m in todo:
        rec = run_cell(arch, shape_name, m, args.out, force=args.force,
                       variant=args.variant)
        ok += rec["status"] == "ok"
        fail += rec["status"] != "ok"
    print(f"dryrun: {ok} ok, {fail} failed, {len(todo)} cells")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
