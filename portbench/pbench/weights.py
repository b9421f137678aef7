"""The served weights, drawn on the device from the seed.

The tree has the port's parameter layout (``embed`` [Vp, D], ``blocks``
with ``wq`` [D, H, dh], ``wk``/``wv`` [D, Hkv, dh], ``wo`` [H, dh, D], the
dense SwiGLU ``wi_gate``/``wi_up`` [D, F] and ``wo_ffn`` [F, D] or the MoE
FFN's ``moe`` = ``router`` [D, E] fp32, ``wg``/``wu`` [E, D, F], ``wd``
[E, F, D]; norms; ``lm_head`` [D, Vp] unless the embedding is tied) and the
scales of the port's own initialiser (std 1/sqrt(D) for the input
projections, 1/sqrt(D L) for the output ones, 0.02 for the embedding and
the router, norms at 1). The numbers are the benchmark's: all bf16 leaves
are views of one buffer filled by ``normal_`` from a ``torch.Generator``
on the device in a few large calls, then scaled group by group. The same
tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

MASK64 = (1 << 64) - 1
_CHUNK = 1 << 30                # elements per normal_ call


def layout(p: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf for the port keys ``p``; init is
    ``in``, ``out``, ``embed``, ``router`` or ``ones``."""
    D, L = p["d_model"], p["num_layers"]
    H, Hkv = p["num_heads"], p["num_kv_heads"]
    dh = p.get("head_dim") or D // H
    V = p["vocab_size"] + p.get("vocab_pad", 0)
    out = [(("embed",), (V, D), "embed"), (("final_norm",), (D,), "ones")]
    if not p.get("tie_embeddings", False):
        out.append((("lm_head",), (D, V), "in"))
    for i in range(L):
        b = ("blocks", i)
        out += [(b + ("attn_norm",), (D,), "ones"),
                (b + ("wq",), (D, H, dh), "in"),
                (b + ("wk",), (D, Hkv, dh), "in"),
                (b + ("wv",), (D, Hkv, dh), "in"),
                (b + ("wo",), (H, dh, D), "out"),
                (b + ("ffn_norm",), (D,), "ones")]
        moe = p.get("moe")
        if moe:
            E, F = moe["num_experts"], moe["d_ff_expert"]
            out += [(b + ("moe", "router"), (D, E), "router"),
                    (b + ("moe", "wg"), (E, D, F), "in"),
                    (b + ("moe", "wu"), (E, D, F), "in"),
                    (b + ("moe", "wd"), (E, F, D), "out")]
        else:
            F = p["d_ff"]
            out += [(b + ("wi_gate",), (D, F), "in"),
                    (b + ("wi_up",), (D, F), "in"),
                    (b + ("wo_ffn",), (F, D), "out")]
    return out


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


def draw(p: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The parameter tree for the port keys ``p`` on ``device``, bf16 but
    for the fp32 router, from ``seed``."""
    if p.get("dtype", "bfloat16") != "bfloat16":
        raise ValueError("the benchmark serves bf16 weights")
    device = torch.device(device)
    D, L = p["d_model"], p["num_layers"]
    std = {"in": 1.0 / math.sqrt(D), "out": 1.0 / math.sqrt(D * L),
           "embed": 0.02, "router": 0.02}
    leaves = layout(p)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & MASK64)
    tree: Dict[str, Any] = {}
    groups = {}
    for kind in ("in", "out", "embed", "router", "ones"):
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
    return tree


def param_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return sum(param_bytes(v) for v in tree)
