"""Trees of tensors as the reference's ``jax.tree`` walks them: dicts in
sorted key order, tuples and lists in order, a NamedTuple by its fields,
``None`` an empty subtree; anything else is a leaf.  The training state,
the optimizer and the checkpoint keys all follow this one order, so the
port's leaves line up with the reference's (``jax.tree.leaves``) and its
checkpoint keys with the reference's ``_flatten`` (``step``,
``params|embed``, ``mu|groups|0|attn|w_k``, ...)."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]]:
    """``(key, child)`` of a node in the reference's flatten order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def leaves_with_paths(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf, in the reference's order."""
    if tree is None:
        return
    if not _is_node(tree):
        yield path, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_paths(child, path + (key,))


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_path(fn: Callable, tree, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``; the
    structure (and a dict's own key order) is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return map_with_path(lambda _, x: fn(x), tree)


def unflatten_like(tree, new_leaves: list):
    """``tree``'s structure with ``new_leaves`` (in :func:`leaves`
    order) in place of its leaves."""
    by_path = dict(zip((p for p, _ in leaves_with_paths(tree)), new_leaves))
    return map_with_path(lambda p, _: by_path[p], tree)
