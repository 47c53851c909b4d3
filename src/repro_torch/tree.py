"""Walks over the port's trees: nests of dicts, lists, tuples and
NamedTuples with tensors (or other values) at the leaves.

The JAX package leaves this to ``jax.tree_util``; the port's parameters,
optimizer state and gradients are plain nests, so these few functions do
what it needs.  Dict keys are visited in sorted order, as JAX flattens
them, so sums over leaves run in the JAX package's order and shard names
come out as its key paths do.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _children(node) -> List[Tuple[Any, Any]] | None:
    """``(key, child)`` pairs of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(name, getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """Every leaf with its key path, depth first, dict keys sorted."""
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for key, child in kids:
        yield from leaves_with_path(child, path + (key,))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def subtrees_up_to(tree, other) -> List[Any]:
    """The subtrees of ``other`` at the leaves of ``tree``, in the order of
    :func:`leaves` (``other`` shares ``tree``'s structure down to its
    leaves, below which it may go on: JAX's ``flatten_up_to``)."""
    kids = _children(tree)
    if kids is None:
        return [other]
    out: List[Any] = []
    for key, child in kids:
        sub = getattr(other, key) if isinstance(key, str) and \
            not isinstance(other, dict) else other[key]
        out.extend(subtrees_up_to(child, sub))
    return out


def map_tree(fn: Callable, tree, *rest):
    """A tree of ``tree``'s structure holding ``fn(leaf, *others)``, where
    ``others`` are the subtrees of ``rest`` at that leaf."""
    return map_tree_with_path(lambda _, *leaf: fn(*leaf), tree, *rest)


def map_tree_with_path(fn: Callable, tree, *rest, path: Path = ()):
    """:func:`map_tree` with ``fn(path, leaf, *others)``: each leaf's key
    path first, as ``jax.tree_util.tree_map_with_path`` passes it."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree, *rest)

    def pick(other, key):
        if isinstance(key, str) and not isinstance(other, dict):
            return getattr(other, key)
        return other[key]

    # fn runs in the order of leaves(); a dict keeps its own key order
    mapped = [map_tree_with_path(fn, child, *(pick(r, key) for r in rest),
                                 path=path + (key,))
              for key, child in kids]
    if isinstance(tree, dict):
        by_key = dict(zip((key for key, _ in kids), mapped))
        return {key: by_key[key] for key in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*mapped)
    return type(tree)(mapped)
