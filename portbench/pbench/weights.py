"""The served weights, drawn on the device from the seed.

An architecture's module (``archs/<arch>.py``) lays the tree out:
``layout(p)`` gives (path, shape, init) of every leaf in draw order. Five
inits are shared, at the scales of the port's own initialiser: ``in``
(std 1/sqrt(D)), ``out`` (1/sqrt(D L)), ``embed`` and ``router`` (0.02,
the router in fp32), ``ones``. All bf16 leaves of the shared inits are
views of one buffer per init filled by ``normal_`` from a
``torch.Generator`` on the device in a few large calls, then scaled. An
init of the module's own is a number (a bf16 constant) or a function
``init(shape, gen)`` returning the leaf on the generator's device; those
are made after the shared ones, so that they change no shared leaf. The
same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

MASK64 = (1 << 64) - 1
_CHUNK = 1 << 30                # elements per normal_ call
KINDS = ("in", "out", "embed", "router", "ones")


def _put(tree: Dict[str, Any], path: Tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if k == "blocks" else {})
    node[path[-1]] = value


def _fill_normal(buf: torch.Tensor, gen: torch.Generator) -> None:
    for a in range(0, buf.numel(), _CHUNK):
        buf[a:a + _CHUNK].normal_(generator=gen)


def draw(p: Dict[str, Any], seed: int, device,
         leaves: List[Tuple[Tuple, Tuple[int, ...], Any]]) -> Dict[str, Any]:
    """The parameter tree for the port keys ``p`` on ``device`` from
    ``seed``, laid out as ``leaves`` (an architecture's ``layout(p)``):
    bf16 but for the fp32 router and what a leaf of its own init makes."""
    if p.get("dtype", "bfloat16") != "bfloat16":
        raise ValueError("the benchmark serves bf16 weights")
    for path, _, init in leaves:
        if isinstance(init, str) and init not in KINDS:
            raise ValueError(f"{path}: unknown init {init!r}")
    device = torch.device(device)
    D, L = p["d_model"], p["num_layers"]
    std = {"in": 1.0 / math.sqrt(D), "out": 1.0 / math.sqrt(D * L),
           "embed": 0.02, "router": 0.02}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & MASK64)
    tree: Dict[str, Any] = {}
    groups = {}
    for kind in KINDS:
        groups[kind] = [lf for lf in leaves if lf[2] == kind]
    dtypes = {"router": torch.float32}
    for kind, members in groups.items():
        n = sum(math.prod(shape) for _, shape, _ in members)
        if not n:
            continue
        dt = dtypes.get(kind, torch.bfloat16)
        if kind == "ones":
            buf = torch.ones(n, dtype=dt, device=device)
        else:
            buf = torch.empty(n, dtype=dt, device=device)
            _fill_normal(buf, gen)
            buf.mul_(std[kind])
        off = 0
        for path, shape, _ in members:
            k = math.prod(shape)
            _put(tree, path, buf[off:off + k].view(shape))
            off += k
    for path, shape, init in leaves:
        if isinstance(init, str):
            continue
        if callable(init):
            _put(tree, path, init(tuple(shape), gen).to(device))
        else:
            _put(tree, path, torch.full(shape, float(init),
                                        dtype=torch.bfloat16, device=device))
    return tree


def param_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return sum(param_bytes(v) for v in tree)
