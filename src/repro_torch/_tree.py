"""Nested dict/list/tuple trees of tensors, walked in the JAX package's
leaf order (``jax.tree_util``): dict keys sorted, lists, tuples and
NamedTuple fields in order, ``None`` an empty subtree.

The optimizer sums the leaves in this order (so a float32 global norm is
comparable with the JAX package's), and the checkpoint names each leaf by
its path in JAX's spelling (``[0]``, ``['embed']``, ``.step``), so that a
checkpoint crosses between the packages."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs; a path is a tuple of JAX key strings."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (f"[{k!r}]",))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_paths(v, prefix + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def map_with_paths(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, paths as in
    ``leaves_with_paths``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, prefix + (f"[{k!r}]",))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, v, prefix + (f".{name}",))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest,
             is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``is_leaf`` stops the walk
    at a subtree, as in ``jax.tree_util.tree_map``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    sub = lambda *xs: tree_map(fn, *xs, is_leaf=is_leaf)   # noqa: E731
    if isinstance(tree, dict):
        return {k: sub(tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(*xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(*xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
