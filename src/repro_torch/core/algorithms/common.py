"""Shared local-work primitives for the algorithm strategies."""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_axpy
from repro_torch.core import client as client_lib


def avg_surrogate_grad(model, cfg):
    """Average grad of s_k over E minibatches (the per-round grad_s_k),
    for a whole cohort at once.

    Every minibatch is evaluated at the SAME params, so the average of the
    E per-batch gradients equals one gradient of the pooled (E*B) batch
    (batches are equal-sized; the lam prox term is affine and averages to
    itself) — one fused forward/backward, as in the JAX package.

    ``fn(params, server_params, xs, ys) -> (g, loss)`` with params stacked
    over the cohort axis P, ``xs`` of shape (P, E, B, ...), ``loss`` (P,).
    """

    def fn(params, server_params, xs, ys):
        P, E, B = xs.shape[:3]
        x = xs.reshape((P, E * B) + tuple(xs.shape[3:]))
        y = ys.reshape((P, E * B) + tuple(ys.shape[3:]))
        g, loss, _ = client_lib.surrogate_grad(
            model.loss, params, server_params,
            {"x": x, "y": y, "task": cfg.task}, cfg.lam,
        )
        return g, loss

    return fn


def sgd_epochs(model, cfg, mu: float = 0.0):
    """E minibatch prox-SGD steps (FedAvg mu=0 / FedProx mu>0 / FedAsync),
    for a whole cohort at once.

    ``fn(params, anchor, xs, ys) -> (params', train_loss)`` with params
    and anchor stacked over the cohort axis P, ``xs`` of shape (P, E, B,
    ...) and ``train_loss`` (P,): the mean of the E per-step losses, each
    taken before its update, as ``repro.core.algorithms.common.
    sgd_epochs`` reports it.  Each step takes every client's gradient
    from one backward pass of the summed per-client losses (the clients
    share no parameter).
    """

    def fn(params, anchor, xs, ys):
        p = params
        losses = []
        for e in range(xs.shape[1]):
            leaf = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            with torch.enable_grad():
                loss, _ = model.loss(leaf, {"x": xs[:, e], "y": ys[:, e],
                                            "task": cfg.task})
                grads = torch.autograd.grad(loss.sum(), list(leaf.values()))
            g = dict(zip(leaf, grads))
            if mu > 0.0:
                g = {k: g[k] + mu * (p[k] - anchor[k]) for k in g}
            p = tree_axpy(-cfg.eta, g, p)
            losses.append(loss.detach())
        return p, torch.stack(losses).mean(dim=0)

    return fn
