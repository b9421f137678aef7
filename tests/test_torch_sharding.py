"""The port's sharding rules and specs (``repro_torch.parallel``) against
the JAX package's, on the CPU, with no devices behind the meshes.

The reference's spec functions take a ``jax.sharding.AbstractMesh`` and the
port's an ``AbstractMesh`` of its own, so the production meshes (16x16 and
2x16x16) are held leaf by leaf for every configuration without 512 ranks:
for params (FSDP off and on, ``expert_tp`` for the MoE ones), AdamW and
Adafactor state, batches and KV caches, every port spec equals the
reference's, the reference's stacked ``[L, ...]`` block leaves compared
without their leading None (the port keeps a list of per-layer leaves).
Per-device argument bytes -- each leaf's shard shape times its element
size, summed -- are equal exactly. Specs are compared normalized: an axis
name or a 1-tuple of it, and None or an empty tuple, are the same entry.
"""
import math

import jax
import pytest
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as rget_config
from repro.models import frontends as RF
from repro.models import transformer as RT
from repro.models.config import ShapeConfig as RShape
from repro.parallel import sharding as RS
from repro.parallel import specs as RSP
from repro.train.optimizer import make_optimizer as rmake_optimizer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES
from repro_torch.models.frontends import input_specs
from repro_torch.parallel import sharding as S
from repro_torch.parallel import specs as SP
from repro_torch.train.optimizer import make_optimizer
from repro_torch.tree import flatten_with_paths

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    out = []
    for e in spec:
        if e is None or e == ():
            out.append(None)
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _rflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rbytes(abstract, shardings):
    a, s = _rflat(abstract), _rflat(shardings)
    return sum(math.prod(s[k].shard_shape(a[k].shape)) * a[k].dtype.itemsize
               for k in a)


def _same(port, ref, what, per_layer_stacked=True):
    """Every port leaf's spec against the reference's leaf of the same
    path (a block leaf ``.../blocks/<l>/...`` against the stacked
    ``.../blocks/...`` without its lead dim)."""
    ps = dict(flatten_with_paths(port))
    rs = _rflat(ref)
    seen = set()
    for key, s in ps.items():
        parts = key.split("/")
        i = parts.index("blocks") if "blocks" in parts else -1
        if per_layer_stacked and i >= 0 and parts[i + 1].isdigit():
            rkey = "/".join(parts[:i + 1] + parts[i + 2:])
            want = _norm(tuple(rs[rkey].spec)[1:])
        else:
            rkey, want = key, _norm(tuple(rs[key].spec))
        assert _norm(s.spec) == want, (what, key, s.spec, rs[rkey].spec)
        seen.add(rkey)
    assert seen == set(rs), (what, set(rs) ^ seen)


def _local_bytes(tree, shardings):
    """Per-device bytes of the port's leaves: shard shape x element size."""
    return sum(math.prod(s.shard_shape(tuple(leaf.shape)))
               * leaf.element_size()
               for (_, leaf), (_, s) in zip(flatten_with_paths(tree),
                                            flatten_with_paths(shardings)))


def _meshes(kind):
    shape, names = MESHES[kind]
    return S.AbstractMesh(shape, names), JMesh(shape, names)


@pytest.mark.parametrize("kind", [None, "one", "single", "multi"])
def test_rules_and_resolve_equal_reference(kind):
    """``make_rules`` and ``resolve`` on no mesh, a 1x1 mesh and the two
    production meshes, FSDP off and on."""
    if kind is None:
        pm = rm = None
    elif kind == "one":
        pm, rm = S.AbstractMesh((1, 1), ("data", "model")), \
            JMesh((1, 1), ("data", "model"))
    else:
        pm, rm = _meshes(kind)
    for fsdp in (False, True):
        p, r = S.make_rules(pm, fsdp=fsdp), RS.make_rules(rm, fsdp=fsdp)
        for ax in ("dp", "fsdp", "tp", "ep", "vocab"):
            assert getattr(p, ax) == getattr(r, ax), (kind, fsdp, ax)
        for logical in (("dp", None, "tp", None), ("dp", "vocab"),
                        ("fsdp", "tp"), (None, "ep", "fsdp", None)):
            assert _norm(p.resolve(*logical)) == _norm(r.resolve(*logical))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_spec_to_placements_round_trip(kind):
    """A spec maps tensor dims to mesh axes, placements map mesh dims to
    tensor dims: every entry of several axes is a ``Shard(d)`` on each of
    them in mesh order, and the inverse gives the spec back."""
    pm, _ = _meshes(kind)
    names = pm.axis_names
    dp = tuple(a for a in names if a != "model")
    specs = [S.P(dp, None, ("model",), None), S.P(None, dp + ("model",)),
             S.P(("model",), dp), S.P(None, None), S.P(dp)]
    for spec in specs:
        ndim = max(len(spec), 2)
        pl = S.spec_to_placements(spec, pm)
        assert len(pl) == len(names)
        for i, name in enumerate(names):
            dims = [d for d, e in enumerate(spec) if e and name in e]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate())
        back = S.placements_to_spec(pl, pm, ndim)
        assert _norm(back) == _norm(spec), (spec, pl, back)
    with pytest.raises(ValueError):      # out of the mesh's order
        S.spec_to_placements(S.P(("model", dp[-1])), pm)
    with pytest.raises(ValueError):      # one axis on two dims
        S.spec_to_placements(S.P(("model",), ("model",)), pm)


def _shape(name):
    s = SHAPES[name]
    return s, RShape(s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_bytes_equal_reference(arch, kind):
    """params (FSDP off/on, expert_tp for MoE), AdamW and Adafactor state,
    every shape's batch and both decode shapes' caches: spec for spec and
    per-device bytes equal the reference's."""
    pm, rm = _meshes(kind)
    cfg = get_config(arch).replace(pad_heads_to=16)
    rcfg = rget_config(arch).replace(pad_heads_to=16)
    pabs, rabs = T.abstract_params(cfg), RT.abstract_params(rcfg)

    for fsdp in (False, True):
        for etp in ((False, True) if cfg.moe else (False,)):
            psh = SP.params_shardings(cfg, pabs, pm, fsdp=fsdp, expert_tp=etp)
            rsh = RSP.params_shardings(rcfg, rabs, rm, fsdp=fsdp,
                                       expert_tp=etp)
            _same(psh, rsh, ("params", fsdp, etp))
            assert _local_bytes(pabs, psh) == _rbytes(rabs, rsh)
        if not fsdp:
            continue
        for opt in ("adamw", "adafactor"):
            popt = make_optimizer(opt).init(pabs)
            ropt = jax.eval_shape(rmake_optimizer(opt).init, rabs)
            posh = SP.opt_state_shardings(psh, popt, pm)
            rosh = RSP.opt_state_shardings(rsh, ropt, rm)
            # AdamW's m/v are per-layer like the params; Adafactor's state
            # is stacked per leaf group, as the reference's
            _same(posh, rosh, opt, per_layer_stacked=(opt == "adamw"))
            assert _local_bytes(popt, posh) == _rbytes(ropt, rosh)

    dp = math.prod(n for a, n in pm.shape.items() if a != "model")
    for name in SHAPES:
        shape, rshape = _shape(name)
        pb = input_specs(cfg, shape)
        rb = dict(RF.input_specs(rcfg, rshape))
        _same(SP.batch_shardings(pb, pm), RSP.batch_shardings(rb, rm),
              ("batch", name))
        assert _local_bytes(pb, SP.batch_shardings(pb, pm)) == \
            _rbytes(rb, RSP.batch_shardings(rb, rm))
        if shape.kind != "decode":
            continue
        B, C = shape.global_batch, shape.seq_len
        pc, rc = T.abstract_cache(cfg, B, C), RT.abstract_cache(rcfg, B, C)
        pcs = SP.cache_shardings(cfg, pc, pm, B)
        rcs = RSP.cache_shardings(rcfg, rc, rm, B)
        _same(pcs, rcs, ("cache", name), per_layer_stacked=False)
        assert _local_bytes(pc, pcs) == _rbytes(rc, rcs)
        ok = B % dp == 0
        _same(SP.batch_shardings({"tokens": pb["tokens"]}, pm,
                                 batch_shardable=ok),
              RSP.batch_shardings({"tokens": rb["tokens"]}, rm,
                                  batch_shardable=ok), ("tokens", name))


def test_named_sharding_shard_shape_equals_reference():
    """``NamedSharding.shard_shape`` divides each dim by its axes' sizes,
    as the reference's does."""
    pm, rm = _meshes("multi")
    for spec, shape in (((("pod", "data"), None, ("model",)), (64, 3, 32)),
                        ((None, ("pod", "data", "model")), (2, 1024)),
                        ((), (5, 7))):
        got = S.NamedSharding(pm, S.P(*spec)).shard_shape(shape)
        assert got == JNamed(rm, JP(*spec)).shard_shape(shape)


def test_sanitize_spec_equals_reference():
    pm, rm = _meshes("single")
    for spec, shape in ((("model", "data"), (48, 40)),
                        ((("data", "model"), None), (512, 3)),
                        ((None, "model"), (7, 8))):
        assert _norm(S.sanitize_spec(spec, shape, pm)) == \
            _norm(RSP.sanitize_spec(JP(*spec), shape, rm))
