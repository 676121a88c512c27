"""Pytrees of the port: nested dicts, lists and tuples of tensors, in
JAX's leaf order.

The optimizer states are flat lists parallel to the parameters' leaves,
and the checkpoint keys are the leaves' key paths, both in the order
``jax.tree.leaves`` gives: a dict's keys sorted, then list and tuple
order.  ``torch.utils._pytree`` walks a dict in insertion order, and the
port's ``init_model`` inserts keys unsorted, so it is not a substitute.
``None`` is an empty subtree, as in JAX; anything else that is not a
dict, list or tuple is a leaf, and so is a node that ``is_leaf`` accepts
(a tree of sharding specs, which are tuples, as JAX's ``is_leaf``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

Path = tuple  # of dict keys and sequence indices


def tree_flatten_with_path(tree: Any, path: Path = (), *,
                           is_leaf: Callable | None = None
                           ) -> Iterator[tuple[Path, Any]]:
    """``(path, leaf)`` pairs in JAX's leaf order."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], path + (k,),
                                              is_leaf=is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_path(v, path + (i,),
                                              is_leaf=is_leaf)
    elif tree is not None:
        yield path, tree


def tree_leaves(tree: Any, *, is_leaf: Callable | None = None) -> list:
    """The leaves, in JAX's order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree,
                                                       is_leaf=is_leaf)]


def key_of(path: Path) -> str:
    """A path as the checkpoint key the JAX store writes (``"0/embed"``,
    ``"1/m/3"``)."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves, keeping the structure; dicts keep their
    insertion order."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in JAX's leaf
    order)."""
    paths = [p for p, _ in tree_flatten_with_path(like)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(paths)}")
    slot = dict(zip(paths, leaves))
    return tree_map_with_path(lambda p, _: slot[p], like)


def tree_map_with_path(fn: Callable, tree: Any, path: Path = (), *,
                       is_leaf: Callable | None = None) -> Any:
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(path, tree)
