"""Nested containers of tensors ("trees"), the port's stand-in for JAX
pytrees: dicts, tuples and lists nest, every other value is a leaf. Dicts
keep their insertion order (JAX sorts dict keys; nothing here depends on
the order)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leaf by leaf over ``tree`` and trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in the order of
    ``tree_leaves(tree)``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
