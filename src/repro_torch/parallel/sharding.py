"""Sharding rules: logical axes -> mesh axes, on ``torch.distributed.tensor``.

The port's counterpart of ``repro.parallel.sharding``. All sharding is
expressed against *logical* axis names bound to mesh axes by a
``ShardingRules`` table, so the same model code serves the single-pod
``("data","model")`` mesh, the multi-pod ``("pod","data","model")`` mesh
and the 1-device path (everything replicated, or no mesh at all).

Conventions
-----------
- "dp"      : batch / token dim                  -> ("pod","data") or ("data",)
- "fsdp"    : param dim sharded for ZeRO/FSDP    -> ("pod","data") when fsdp on
- "tp"      : tensor-parallel dim (heads, d_ff)  -> ("model",)
- "ep"      : expert-parallel dim (num_experts)  -> ("model",)
- "vocab"   : vocab dim of embed / lm_head       -> ("model",)

torch has no ``PartitionSpec``; the port keeps its own (a tuple, one entry
per tensor dim: None, or a tuple of mesh axis names). A DTensor says the
same thing the other way round: one placement per *mesh* dim.
``spec_to_placements`` is the one translation between the two: a tensor
dim sharded over several axes (``("pod","data")``) becomes ``Shard(d)`` on
each of those mesh dims, major to minor in the mesh's order, which is how
both JAX and DTensor lay such a dim out.

A mesh is a ``DeviceMesh`` (with ``mesh_dim_names``) or an
``AbstractMesh`` (axis sizes and names, no process group): the spec
functions of ``parallel/specs.py`` take either, so the production meshes'
specs can be computed without 512 ranks. ``constrain`` acts only on a
DTensor under a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement
from torch.distributed.tensor.experimental import implicit_replication

# ---------------------------------------------------------------------------
# Specs and meshes


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated) or mesh axis name(s)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices behind it."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, entry) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(entry))


def sanitize_spec(spec: Sequence, shape, mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh axes don't divide evenly (explicit
    input shardings -- unlike internal GSPMD propagation -- must divide)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        n = axis_size(mesh, entry)
        out.append(entry if (n > 1 and dim % n == 0) or n == 1 else None)
    return P(*out)


def spec_to_placements(spec: Sequence, mesh) -> tuple:
    """PartitionSpec (tensor dims -> mesh axes) -> DTensor placements (mesh
    dims -> tensor dims). Every mesh axis named on tensor dim d becomes
    ``Shard(d)``; a dim's axes must come in the mesh's order (major first),
    the only order a run of ``Shard(d)`` placements expresses; the rest
    replicate."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} names mesh axes out of the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two "
                                 "dims")
            out[i] = Shard(d)
    return tuple(out)


def placements_to_spec(placements: Sequence, mesh, ndim: int
                       ) -> PartitionSpec:
    """The inverse of ``spec_to_placements``: entries are tuples of axis
    names (as ``ShardingRules.resolve`` gives them) or None."""
    names = axis_names(mesh)
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            dims[pl.dim % ndim].append(name)
        elif pl != Replicate():
            raise ValueError(f"{pl} has no PartitionSpec")
    return P(*(tuple(d) if d else None for d in dims))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The per-device shape of a ``shape`` leaf (the spec divides it)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(d // axis_size(self.mesh, e) for d, e in zip(shape, spec))


# ---------------------------------------------------------------------------
# Rule table


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    dp: Tuple[str, ...] = ()
    fsdp: Tuple[str, ...] = ()
    tp: Tuple[str, ...] = ()
    ep: Tuple[str, ...] = ()
    vocab: Tuple[str, ...] = ()

    def resolve(self, *logical: Optional[str]) -> PartitionSpec:
        """Map a tuple of logical axis names (or None) to a PartitionSpec."""
        out = []
        for ax in logical:
            if ax is None:
                out.append(None)
            else:
                mesh_axes = getattr(self, ax)
                out.append(mesh_axes if mesh_axes else None)
        return P(*out)


def make_rules(mesh, fsdp: bool = False) -> ShardingRules:
    """Build the rule table for a mesh (None -> fully replicated)."""
    if mesh is None:
        return ShardingRules()
    names = axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axes = ("model",) if "model" in names else ()
    return ShardingRules(
        dp=batch_axes,
        fsdp=batch_axes if fsdp else (),
        tp=model_axes,
        ep=model_axes,
        vocab=model_axes,
    )


# ---------------------------------------------------------------------------
# Ambient mesh plumbing (model code looks sharding up here)

_CURRENT: dict = {"mesh": None, "rules": ShardingRules()}
_IMPLICIT: list = []        # the outermost mesh context's, then a None each


class use_mesh:
    """Context manager binding the ambient mesh + rules for model code.
    Under a mesh a plain tensor meeting a DTensor in an op counts as
    replicated (``implicit_replication``, held from the outermost mesh
    context in to the last one out, as it does not nest): the model's
    index tensors and masks are built as plain tensors, as the reference
    builds them with no sharding."""

    def __init__(self, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.rules = make_rules(mesh, fsdp=fsdp)

    def __enter__(self):
        self._saved = dict(_CURRENT)
        _CURRENT["mesh"] = self.mesh
        _CURRENT["rules"] = self.rules
        if self.mesh is not None:
            if not _IMPLICIT:
                ctx = implicit_replication()
                ctx.__enter__()
                _IMPLICIT.append(ctx)
            else:
                _IMPLICIT.append(None)
        return self

    def __exit__(self, *exc):
        if self.mesh is not None:
            ctx = _IMPLICIT.pop()
            if ctx is not None:
                ctx.__exit__(*exc)
        _CURRENT.update(self._saved)
        return False


def current_mesh():
    return _CURRENT["mesh"]


def current_rules() -> ShardingRules:
    return _CURRENT["rules"]


def placements_for(shape, *logical: Optional[str]) -> tuple:
    """DTensor placements of the logical axes on the ambient mesh for a
    tensor of ``shape`` (the reference's ``logical_sharding``), sanitized:
    a dim the axes don't divide is replicated (GSPMD pads it, DTensor
    would shard it unevenly), so every rank holds one shape."""
    mesh = current_mesh()
    return spec_to_placements(sanitize_spec(current_rules().resolve(
        *logical), shape, mesh), mesh)


def pin(x):
    """``x`` itself; a DTensor's gradient comes back laid out as ``x`` is.
    For a view of a weight (``w.reshape(D, -1)``): left to itself DTensor
    may return its gradient split where the view cannot be undone."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False)


def constrain(x, *logical: Optional[str]):
    """Redistribute a DTensor to the logical axes' layout (the reference's
    ``with_sharding_constraint``); a no-op without a mesh or on a plain
    tensor (``placements_for`` gives the layout)."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = placements_for(x.shape, *logical)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def shard_map(fn, args, in_logical, out_placements):
    """``fn`` on each rank's local shards under the ambient mesh: the
    reference's ``shard_map``, for the parts of the model DTensor cannot
    propagate a layout through (an attention core over sharded batch and
    heads, a recurrence, the MoE dispatch). Each tensor of ``args`` is laid
    out by its entry of ``in_logical`` (logical axes, laid out by
    ``placements_for``; None passes the argument as it is) and handed to
    ``fn`` as its local shard. ``out_placements(placements)`` takes the
    inputs' placements (None for a passed argument) and gives each
    output's (a tuple of them for a tuple of outputs): the outputs come
    back as DTensors of those placements. Without a mesh, or with no
    DTensor among ``args``, it is ``fn(*args)``."""
    mesh = current_mesh()
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    placements = [
        None if logical is None or not isinstance(a, torch.Tensor) else
        placements_for(a.shape, *logical)
        for a, logical in zip(args, in_logical)]
    return shard_map_placements(fn, args, placements,
                                out_placements(placements))


def shard_map_placements(fn, args, in_placements, out_placements):
    """``shard_map`` with explicit DTensor placements: ``in_placements``
    per argument (None passes it as it is), ``out_placements`` for the
    output (a tuple of them for a tuple of outputs; a plain tensor among
    the arguments counts as replicated). An output may be ``Partial`` on a
    mesh dim: each rank's value is a summand (the reference's ``psum``
    left to the consumer).

    Gradients flow as through JAX's ``shard_map``: on a mesh dim where
    some output varies across ranks (sharded or partial), an argument
    replicated over it gets a partial gradient (each rank's use is a
    summand); where every output is replicated, every rank computed the
    same, and its gradient stays replicated."""
    mesh = current_mesh()
    outs = (out_placements,) if isinstance(out_placements[0], Placement) \
        else out_placements
    varying = {i for pls in outs for i, pl in enumerate(pls)
               if pl != Replicate()}
    local = []
    for a, pl in zip(args, in_placements):
        if pl is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        grad_pl = tuple(Partial() if i in varying and p == Replicate() else p
                        for i, p in enumerate(pl))
        local.append(a.redistribute(mesh, tuple(pl)).to_local(
            grad_placements=grad_pl))
    out = fn(*local)
    if isinstance(out, torch.Tensor):
        return DTensor.from_local(out, mesh, out_placements, run_check=False)
    return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                 for o, pl in zip(out, outs))


def mesh_coordinate(mesh, dims) -> int:
    """This rank's index along the mesh dims ``dims`` taken together (major
    first): which shard of a tensor dim sharded over them it holds."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def mesh_dims(mesh, placements, dim: int) -> Tuple[int, ...]:
    """The mesh dims whose placement shards tensor dim ``dim``."""
    return tuple(i for i, pl in enumerate(placements)
                 if isinstance(pl, Shard) and pl.dim == dim)
