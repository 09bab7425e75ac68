"""Flatten and rebuild nested parameter containers.

The port keeps the JAX package's parameter pytrees — ``{layer: [blob,
...]}`` dicts, tuples of them, NamedTuples — and this module walks them
in ``jax.tree_util.tree_flatten``'s order: dict keys sorted, sequences
in order, ``None`` an empty subtree.  The comm plane's byte-balanced
chunking depends on that order (``parallel/comm.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree) -> Iterator[Any]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _walk(x)
    else:
        yield tree


def tree_leaves(tree) -> List[Any]:
    """Leaves of ``tree`` in ``jax.tree_util`` order."""
    return list(_walk(tree))


def tree_unflatten(like, leaves) -> Any:
    """A container shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    cols = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
