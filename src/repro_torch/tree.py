"""Trees of tensors — the few pytree operations the port's training path
needs (``jax.tree.map``, ``jax.tree.leaves`` and the checkpoint's key
paths).

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
any other objects) as leaves.  Maps keep each node's type and a dict's
key order.  ``flatten_with_paths`` names each leaf as the reference's
checkpoint does (``jax.tree_util.tree_flatten_with_path``, then ``"/"``-
joined): a dict key as itself, a list or tuple index as its number, a
NamedTuple field as ``"." + name``; for example ``.master/layers/wq``
for an ``OptState``.  So a checkpoint written by either package restores
in the other.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = [("." + f, v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, v in items:
        out += flatten_with_paths(v, f"{prefix}/{key}" if prefix else key)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]
