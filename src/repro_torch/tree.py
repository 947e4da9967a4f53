"""Parameter trees: nested dicts whose leaves are tensors.

The port's stand-in for ``jax.tree`` over the reference's parameter and
optimizer-state pytrees, which are nested dicts with array leaves.  Leaf
order is dict order, the order the reference's flattening gives for
dicts built in sorted key order and the order the port builds them in.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def named_leaves(tree: Any, prefix: str = "") -> list:
    """``[(path, leaf)]`` with paths joined by ``/`` (``"leaf"`` for a
    bare leaf), as the reference's checkpoint manifest names them."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1] or "leaf", tree)]


def map_named(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` applied leaf by leaf, paths as
    :func:`named_leaves` gives them."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1] or "leaf", tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
