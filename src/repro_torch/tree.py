"""Trees of tensors: nested dicts and lists, as the port keeps parameters,
optimizer states and checkpoints. Leaves come in the reference's pytree
order — dict keys sorted, list items by index — with key paths joined by
``/`` (``params/blocks/0/wq``), the order and names of
``jax.tree_util.tree_flatten_with_path``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key path, leaf)] in pytree order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out += flatten_with_paths(sub, f"{prefix}/{name}" if prefix else name)
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten_like(template: Any, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in pytree order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def map_tree(fn: Callable, tree: Any) -> Any:
    return unflatten_like(tree, [fn(x) for x in leaves(tree)])
