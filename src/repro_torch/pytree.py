"""The reference's tree order for the port's nested containers.

``jax.tree.flatten`` visits a dict's keys sorted, a NamedTuple's fields
in order, a list or tuple in order, and treats None as a node with no
leaves. ``torch.utils._pytree`` visits a dict in insertion order, so
the whole package flattens with this module instead (``models.api``
re-exports it): one order holds for the layer scans, the optimizer's
global norm and the checkpoint's ``arr_<i>`` files, and a checkpoint
written by either package lists its leaves in the same order.
"""
from __future__ import annotations

from typing import Callable, Optional

_LEAF = object()


def _is_seq(t) -> bool:
    """A list, a tuple or a NamedTuple (not another tuple subclass, such
    as ``torch.Size``, which is a leaf as jax.tree takes it)."""
    return type(t) in (list, tuple) or (isinstance(t, tuple)
                                        and hasattr(t, "_fields"))


def _walk(t, is_leaf, out):
    if is_leaf is not None and is_leaf(t):
        out.append(t)
        return _LEAF
    if t is None:
        return None
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, keys, [_walk(t[k], is_leaf, out) for k in keys])
    if _is_seq(t):
        return (type(t), None, [_walk(x, is_leaf, out) for x in t])
    out.append(t)
    return _LEAF


def _build(d, it):
    if d is _LEAF:
        return next(it)
    if d is None:
        return None
    kind, keys, kids = d
    vals = [_build(k, it) for k in kids]
    if kind is dict:
        return dict(zip(keys, vals))
    if kind in (list, tuple):
        return kind(vals)
    return kind(*vals)                            # a NamedTuple


# module-level recursion: a nested recursive function would hold itself
# and the leaves in a reference cycle, and keep every tensor of the tree
# alive until the garbage collector runs

def flatten(tree, is_leaf: Optional[Callable] = None) -> tuple:
    """(leaves, treedef) in ``jax.tree.flatten``'s order."""
    out = []
    treedef = _walk(tree, is_leaf, out)
    return out, treedef


def unflatten(treedef, leaves) -> object:
    """The tree of ``treedef`` (from ``flatten``) holding ``leaves``."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree holds")
    return out


def leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return flatten(tree, is_leaf)[0]


def _up_to(d, t, out):
    if d is _LEAF:
        out.append(t)
        return
    if d is None:
        return
    kind, keys, kids = d
    if kind is dict:
        if not isinstance(t, dict) or sorted(t) != keys:
            raise ValueError(f"trees differ: keys {keys} and {t!r:.80}")
        t = [t[k] for k in keys]
    elif not _is_seq(t) or len(t) != len(kids):
        raise ValueError(f"trees differ: {len(kids)} children and "
                         f"{t!r:.80}")
    for k, x in zip(kids, t):
        _up_to(k, x, out)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and, as ``jax.tree.map`` does,
    whatever each tree in ``rest`` holds at those places (a subtree
    there, such as a spec tuple, is passed whole)."""
    flat, treedef = flatten(tree, is_leaf)
    others = []
    for r in rest:
        others.append([])
        _up_to(treedef, r, others[-1])
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
