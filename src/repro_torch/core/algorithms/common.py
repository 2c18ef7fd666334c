"""Shared local-work primitives for the algorithm strategies."""
from __future__ import annotations

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
