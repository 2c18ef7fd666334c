"""Minimal optimizer library: pure ``(init, update)`` transforms over dicts
of tensors, as ``repro.optim.optimizers`` (optax-style, no dependency).

``update(grads, state, params)`` returns ``(updates, new state)`` and
writes nothing in place; ``apply_updates`` adds the updates.  The order
and dtype of every operation follow the JAX code.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return (tree_map(lambda m: -lr_t * m, mu),
                    {"step": step, "mu": mu})
        return (tree_map(lambda g: -lr_t * g, grads),
                {"step": step, "mu": None})

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
        lr_t = lr_fn(step)

        def upd(mi, vi, p):
            u = -lr_t * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u.to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before).  The scale is an fp32 array, so bf16 leaves come back fp32,
    as JAX promotes them."""
    leaves = tree_leaves(grads)
    norm = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:  # jax.tree.reduce(jnp.add, ...): leaf order, from 0
        norm = norm + torch.sum(torch.square(g.to(torch.float32)))
    norm = torch.sqrt(norm)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step (int tensor) -> fp32 learning rate: linear warm-up over
    ``warmup`` steps, then a cosine decay to 0 at ``total``."""

    def fn(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
