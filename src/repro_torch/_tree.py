"""Parameter and state trees in ``jax.tree``'s leaf order.

The port keeps the reference's trees as plain Python containers of
tensors: dicts, lists, tuples and NamedTuples (``OptState``,
``AdafactorState``, ``_Factored``).  Everything that depends on the order
of the leaves -- the clip norm's sum, a checkpoint's ``leaf_%05d.npy``
index, the coded-gradient flatten -- walks them as ``jax.tree`` does:
dict keys sorted, lists, tuples and NamedTuples in order, ``None`` an
empty node.  So a checkpoint written by the reference restores into the
port leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["flatten", "unflatten", "leaves", "map"]


class _Leaf:
    """A leaf's place in a tree's skeleton."""

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(t, out: List[Any], is_leaf):
    if is_leaf is not None and is_leaf(t):
        out.append(t)
        return _LEAF
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _walk(t[k], out, is_leaf) for k in sorted(t)}
    if _is_namedtuple(t):
        return type(t)(*(_walk(v, out, is_leaf) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(v, out, is_leaf) for v in t)
    out.append(t)
    return _LEAF


def _build(s, it):
    if s is _LEAF:
        return next(it)
    if s is None:
        return None
    if isinstance(s, dict):
        return {k: _build(s[k], it) for k in sorted(s)}
    if _is_namedtuple(s):
        return type(s)(*(_build(v, it) for v in s))
    return type(s)(_build(v, it) for v in s)


# The walks are module functions, not nested closures: a recursive
# closure is a reference cycle, which would hold the leaves (a train
# step's gradients, a checkpoint's tensors) until the cyclic collector
# runs.

def flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Any]:
    """(leaves in ``jax.tree`` order, the tree's skeleton).  ``is_leaf``
    stops the walk at the nodes it accepts, as in ``jax.tree``."""
    out: List[Any] = []
    skeleton = _walk(tree, out, is_leaf)
    return out, skeleton


def unflatten(skeleton, leaves_: List[Any]):
    """The tree of ``skeleton`` (from :func:`flatten`) holding ``leaves_``
    in order."""
    it = iter(leaves_)
    tree = _build(skeleton, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the skeleton holds")
    return tree


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def map(fn: Callable, tree, *rest, is_leaf=None):  # noqa: A001
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as ``jax.tree.map``."""
    lv, skeleton = flatten(tree, is_leaf)
    others = [flatten(t, is_leaf)[0] for t in rest]
    for o in others:
        if len(o) != len(lv):
            raise ValueError(f"map: trees of {len(lv)} and {len(o)} leaves")
    return unflatten(skeleton, [fn(*xs) for xs in zip(lv, *others)])
