"""Shared local-work primitives for the algorithm strategies, and the
codec of the engine's stacked client state."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.dtypes import resolve_state_storage
from repro_torch.common.pytree import tree_axpy, tree_map
from repro_torch.core import client as client_lib


# ---------------------------------------------------------------------------
# Delta-compressed stacked client state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientStateCodec:
    """Encode/decode rule for the engine's stacked per-client state
    (``repro.core.algorithms.common.ClientStateCodec``, same arithmetic).

    ``anchor`` has the *state* structure: parameter-like leaves hold the
    (constant) reference model ``w0``, gradient-like slots hold zeros.
    ``mask`` mirrors it with a bool per leaf: ``False`` leaves (control
    scalars: round counters, sample counts) pass through untouched.
    Both directions are elementwise and broadcast over a leading
    stacked-client axis.

    Float dtypes store ``(x - anchor).to(dtype)`` and decode
    ``anchor + x.to(anchor.dtype)``.  Integer dtypes store the
    fixed-point code ``clip(round((x - anchor) / scale), -levels,
    levels)`` with a per-leaf fp32 ``scale`` and decode ``anchor +
    code * scale`` (two roundings, no fused multiply-add); codes are
    stable under re-encode, which keeps host-pool round trips
    idempotent.  ``scale`` leaves are 0-d fp32 tensors on the anchor's
    device, so the card divides exactly as the CPU does (a CUDA division
    by a Python scalar multiplies by its reciprocal).

    A ``dtype`` of fp32 (or ``anchor=None``) is the identity codec.
    """

    dtype: Any
    anchor: Any = None
    mask: Any = None
    # quantized codecs only: per-leaf fp32 scale tree + half-range
    scale: Any = None
    levels: Any = None

    @property
    def identity(self) -> bool:
        return self.anchor is None or self.dtype == torch.float32

    def encode(self, state):
        if self.identity:
            return state
        if self.levels is not None:
            lv = float(self.levels)
            return tree_map(
                lambda x, a, m, s: torch.clamp(
                    torch.round((x - a) / s), -lv, lv).to(self.dtype)
                if m else x,
                state, self.anchor, self.mask, self.scale)
        return tree_map(lambda x, a, m: (x - a).to(self.dtype) if m else x,
                        state, self.anchor, self.mask)

    def decode(self, state):
        if self.identity:
            return state
        if self.levels is not None:
            return tree_map(
                lambda x, a, m, s: a + x.to(a.dtype) * s if m else x,
                state, self.anchor, self.mask, self.scale)
        return tree_map(lambda x, a, m: a + x.to(a.dtype) if m else x,
                        state, self.anchor, self.mask)


def make_state_codec(cfg, anchor, mask):
    """The stacked-state codec for ``cfg.state_dtype``: None for fp32 (or
    None), the delta-cast codec for bf16 / fp16, the quantized delta
    codec with ``scale = cfg.state_qclip / levels`` for int8 / int4."""
    storage = resolve_state_storage(cfg.state_dtype)
    if storage is None or storage.dtype == torch.float32:
        return None
    scale = None
    if storage.quantized:
        qclip = float(getattr(cfg, "state_qclip", 0.5))
        if not qclip > 0.0:
            raise ValueError(
                f"state_qclip must be positive for quantized state dtype "
                f"{cfg.state_dtype!r}; got {qclip!r}")
        per_leaf = qclip / storage.levels
        scale = tree_map(lambda a: torch.full(
            (), per_leaf, dtype=torch.float32, device=a.device), anchor)
    return ClientStateCodec(dtype=storage.dtype, anchor=anchor, mask=mask,
                            scale=scale, levels=storage.levels)


def bool_tree(tree, flag: bool):
    """A tree of ``flag`` with ``tree``'s structure (codec mask helper)."""
    return tree_map(lambda _: flag, tree)


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
