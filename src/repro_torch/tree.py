"""Nested dicts, lists and tuples of tensors: the port's pytrees.

The reference keeps params and optimizer state as JAX pytrees; the port
keeps the same nesting as plain dicts and lists.  Dict keys are walked in
sorted order, as ``jax.tree`` walks them, so a tree's leaves come in one
fixed order whatever order its dicts were built in.
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def leaves(tree) -> list:
    """The leaves of ``tree`` in its fixed order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for k in kids for x in leaves(k)]


def paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path (``"blocks/0/attn/wq"``), in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def tree_map(fn, *trees):
    """``fn`` over matching leaves of trees of the first one's structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


_END = object()


def unflatten(like, flat):
    """A tree of ``like``'s structure holding ``flat``'s leaves, which come
    in :func:`leaves` order; raises ``ValueError`` if the counts differ."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("unflatten: fewer leaves than the tree "
                             "has") from None

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the tree has")
    return out
