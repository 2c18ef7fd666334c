"""ASO-Fed client update as a reusable transform (Algorithm 2 lines
11-16), over dicts of tensors.

Mirrors ``repro.optim.asofed``: the decay recursion (h, v) lives in
optimizer slots shaped like the parameters, and ``asofed_transform``
turns a gradient into the update with the prox term (Eq. 7), the Eq. (8)
correction and the Eq. (11) dynamic step size.  Plain functions, not
``torch.optim``: each operation and its dtype follow the JAX code, so
both packages round alike.  Slot arithmetic runs in the slots' own dtype
(fp32 from ``init_slots``; bf16 slots halve their memory).  A zero-size
slot leaf (``torch.zeros((0,))``) marks a parameter left out of the
recursion: it takes plain prox-SGD and keeps its empty slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map


@dataclasses.dataclass
class AsoFedSlots:
    h: Any  # Eq. (9) balance slot
    v: Any  # previous surrogate gradient
    delay_sum: torch.Tensor  # () fp32
    rounds: torch.Tensor  # () fp32


def init_slots(params) -> AsoFedSlots:
    """Zero fp32 (h, v) slots shaped like ``params``, on their device."""
    z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = tree_leaves(params)[0].device
    return AsoFedSlots(
        h=z, v=tree_map(torch.clone, z),
        delay_sum=torch.zeros((), dtype=torch.float32, device=dev),
        rounds=torch.zeros((), dtype=torch.float32, device=dev))


def _active(h: torch.Tensor) -> bool:
    return h.numel() > 0


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``like``'s dtype, as ``jnp.asarray(x, dtype)``: a
    Python scalar would enter a bf16 product unrounded."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def asofed_transform(grads, slots: AsoFedSlots, params, server_params, *,
                     lam: float, beta: float, eta: float, delay,
                     dynamic_lr: bool = True) -> Tuple[Any, AsoFedSlots]:
    """grads = grad f_k(w_k) -> (updates, new slots); nothing is written
    in place.  ``delay``: the client's delay this round (a float or a 0-d
    tensor, taken as fp32)."""

    def _gs(g, w, s, h):
        # active slots: the slot's dtype; inactive ones stay in the
        # gradient's dtype (no fp32 shadow chain for excluded params)
        dt = h.dtype if _active(h) else g.dtype
        if lam == 0.0:  # fused-round mode: the prox vanishes at w_k == w^t
            return g.to(dt)
        d = (w - s).to(dt)
        return g.to(dt) + _const(lam, d) * d

    gs = tree_map(_gs, grads, params, server_params, slots.h)
    zeta = tree_map(lambda g, v, h: (g - v + h) if _active(h) else g,
                    gs, slots.v, slots.h)
    delay = torch.as_tensor(delay, dtype=torch.float32,
                            device=slots.delay_sum.device)
    if dynamic_lr:
        dbar = (slots.delay_sum + delay) / torch.clamp(slots.rounds + 1.0,
                                                       min=1.0)
        r = torch.clamp(torch.log(torch.clamp(dbar, min=1e-6)), min=1.0)
    else:
        r = torch.ones((), dtype=torch.float32, device=delay.device)
    step = -(r * eta)
    updates = tree_map(lambda z: step.to(z.dtype) * z, zeta)
    new_h = tree_map(
        lambda h, v: (_const(beta, h) * h + _const(1.0 - beta, h) * v
                      if _active(h) else h),
        slots.h, slots.v)
    new_v = tree_map(lambda g, v: g if _active(v) else v, gs, slots.v)
    return updates, AsoFedSlots(h=new_h, v=new_v,
                                delay_sum=slots.delay_sum + delay,
                                rounds=slots.rounds + 1.0)
