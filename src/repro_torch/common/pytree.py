"""Parameter-tree arithmetic for the port: ``dict[str, Tensor]`` leaf-wise.

The port's parameter trees are flat dicts of tensors in the JAX package's
layouts, so every helper is a dict comprehension over the shared keys.
All of them allocate fresh tensors (no in-place update): the engine
decides where an in-place write is safe (the stacked-state scatter).
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def bcast_rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row ``(P,)`` coefficient shaped to broadcast against a
    ``(P, ...)`` leaf; a 0-d or ``(1,)`` scalar passes through."""
    if v.dim() <= 1 and v.numel() == 1:
        return v.reshape(())
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def tree_sub(a: Tree, b: Tree) -> Tree:
    """a - b, leaf-wise."""
    return {k: a[k] - b[k] for k in a}


def tree_axpy(s, x: Tree, y: Tree) -> Tree:
    """s * x + y, leaf-wise (the BLAS axpy).  ``s`` is a scalar, or a
    per-row ``(P,)`` tensor for trees stacked over a leading axis."""
    if isinstance(s, torch.Tensor):
        return {k: bcast_rows(s, x[k]) * x[k] + y[k] for k in x}
    return {k: s * x[k] + y[k] for k in x}


def tree_zeros_like(a: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in a.items()}


def tree_take(tree: Tree, idx: torch.Tensor) -> Tree:
    """Gather rows ``idx`` (int64 tensor) along each leaf's leading axis."""
    return {k: v.index_select(0, idx) for k, v in tree.items()}


def tree_scatter(tree: Tree, idx: torch.Tensor, values: Tree) -> Tree:
    """Write ``values`` (leading axis == len(idx)) back at rows ``idx``,
    in place.  Duplicate indices write in undefined order — callers
    reserve a scratch row for padded cohort slots and give every padded
    slot that row's own value, so repeated indices are harmless."""
    for k, v in tree.items():
        v.index_copy_(0, idx, values[k])
    return tree


def tree_where(pred: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Leaf-wise ``where``: ``pred`` is a scalar or a per-row ``(P,)``
    mask broadcast against ``(P, ...)`` leaves."""
    return {k: torch.where(bcast_rows(pred, a[k]) if pred.dim() else pred,
                           a[k], b[k]) for k in a}
