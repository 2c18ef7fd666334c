"""Parameter-tree arithmetic for the port: nested trees of tensors.

A tree is a tensor (a leaf), a ``dict`` of trees, or a dataclass instance
whose fields are trees (the port's ``ClientState``) — the shapes the JAX
package's pytrees take in the cohort engine: flat model parameters
``{"w_x": ..., ...}``, strategy state ``{"w": {...}, "version": t}``,
uploads ``{"wk": {...}, "version": ...}``.  Dict keys are visited in
sorted order, as ``jax.tree`` does, so two trees of one structure flatten
to matching leaf lists.  Every helper allocates fresh tensors except
:func:`tree_scatter`, which writes in place: the engine decides where an
in-place write is safe (the stacked-state scatter).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import torch

Tree = Any  # torch.Tensor | Dict[str, Tree] | dataclass of Trees


def _is_node(x) -> bool:
    return isinstance(x, dict) or (dataclasses.is_dataclass(x)
                                   and not isinstance(x, type))


def _children(x) -> Tuple[Tuple[str, ...], List]:
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return keys, [x[k] for k in keys]
    keys = tuple(f.name for f in dataclasses.fields(x))
    return keys, [getattr(x, k) for k in keys]


def _rebuild(x, keys: Sequence[str], vals: Sequence) -> Tree:
    if isinstance(x, dict):
        return dict(zip(keys, vals))
    return dataclasses.replace(x, **dict(zip(keys, vals)))


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    keys, kids = _children(tree)
    others = [_children(r)[1] for r in rest]
    return _rebuild(tree, keys, [
        tree_map(fn, k, *(o[i] for o in others))
        for i, k in enumerate(kids)])


def tree_flatten(tree: Tree) -> Tuple[List[torch.Tensor], Tree]:
    """``(leaves, treedef)``; ``treedef`` is the tree itself, used only
    for its structure by :func:`tree_unflatten`."""
    return tree_leaves(tree), tree


def tree_unflatten(treedef: Tree, leaves: Sequence[torch.Tensor]) -> Tree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), treedef)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if not _is_node(tree):
        return [tree]
    return [leaf for kid in _children(tree)[1] for leaf in tree_leaves(kid)]


def tree_stack(trees: Sequence[Tree]) -> Tree:
    """Stack trees of one structure along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_repeat(tree: Tree, n: int) -> Tree:
    """``n`` copies of ``tree`` stacked along a new leading axis, in fresh
    memory (the engine scatters into a stacked state in place)."""
    return tree_map(
        lambda v: v.unsqueeze(0).expand((n,) + tuple(v.shape)).clone(), tree)


def bcast_rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row ``(P,)`` coefficient shaped to broadcast against a
    ``(P, ...)`` leaf; a 0-d or ``(1,)`` scalar passes through."""
    if v.dim() <= 1 and v.numel() == 1:
        return v.reshape(())
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def tree_sub(a: Tree, b: Tree) -> Tree:
    """a - b, leaf-wise."""
    return tree_map(torch.sub, a, b)


def tree_axpy(s, x: Tree, y: Tree) -> Tree:
    """s * x + y, leaf-wise (the BLAS axpy).  ``s`` is a scalar, or a
    per-row ``(P,)`` tensor for trees stacked over a leading axis."""
    if isinstance(s, torch.Tensor):
        return tree_map(lambda xi, yi: bcast_rows(s, xi) * xi + yi, x, y)
    return tree_map(lambda xi, yi: s * xi + yi, x, y)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_take(tree: Tree, idx: torch.Tensor) -> Tree:
    """Gather rows ``idx`` (int64 tensor) along each leaf's leading axis."""
    return tree_map(lambda v: v.index_select(0, idx), tree)


def tree_scatter(tree: Tree, idx: torch.Tensor, values: Tree) -> Tree:
    """Write ``values`` (leading axis == len(idx)) back at rows ``idx``,
    in place.  Duplicate indices write in undefined order — callers
    reserve a scratch row for padded cohort slots and give every padded
    slot that row's own value, so repeated indices are harmless."""
    for v, new in zip(tree_leaves(tree), tree_leaves(values)):
        v.index_copy_(0, idx, new)
    return tree


def tree_where(pred: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Leaf-wise ``where``: ``pred`` is a scalar or a per-row ``(P,)``
    mask broadcast against ``(P, ...)`` leaves."""
    return tree_map(
        lambda x, y: torch.where(bcast_rows(pred, x) if pred.dim() else pred,
                                 x, y), a, b)

