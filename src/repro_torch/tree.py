"""Trees of tensors (nested dicts, lists and tuples), walked in
``jax.tree_util`` order: dict keys sorted, lists and tuples in order.  The
reference's checkpoints name leaves by this order's ``keystr`` paths."""

from __future__ import annotations


def named_leaves(tree, path: str = ""):
    """(keystr path, leaf) pairs, e.g. ``("['blocks'][0]['attn']['wq']", t)``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def leaf_paths(tree, path: tuple = ()):
    """Each leaf's key path as a tuple (dict keys, sequence indices), in
    :func:`named_leaves` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (i,))
    else:
        yield path


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def rebuild(like, it):
    """``like``'s structure with its leaves taken from the iterator ``it``,
    in :func:`named_leaves` order."""
    if isinstance(like, dict):
        return {k: rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(rebuild(v, it) for v in like)
    return next(it)


def tree_map(fn, tree):
    return rebuild(tree, iter([fn(leaf) for leaf in leaves(tree)]))
