"""ASO-Fed client state and local-update math (paper §4.2, Alg. 2 l. 9-17).

Per received central model w^t the client computes

    s_k(w_k)   = f_k(w_k) + (lambda/2) ||w_k - w^t||^2          (Eq. 7)
    grad_zeta  = grad_s - grad_s_pre + h_pre                    (Eq. 8)
    h          = beta * h + (1 - beta) * v                      (Eq. 9 / line 15)
    w_k^{t+1}  = w_k^t - r_k^t * eta_bar * grad_zeta            (Eq. 10-11)
    v          = grad_s (current)                               (line 16)

with the dynamic step multiplier r_k^t = max(1, log(mean past delay)).
The cohort engine keeps one :class:`ClientState` whose tensors are
stacked over a leading client axis; every function here works on that
stacked form (scalars become ``(P,)`` vectors).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

from repro_torch.common.pytree import Tree, tree_zeros_like

_TREES = ("params", "server_params", "h", "v")
_SCALARS = ("delay_sum", "rounds", "n_samples")


@dataclasses.dataclass
class ClientState:
    """Everything client k carries between rounds."""

    params: Tree  # w_k
    server_params: Tree  # latest received w^t
    h: Tree  # Eq. (9) balance slot
    v: Tree  # previous surrogate gradient (grad_s_pre)
    delay_sum: torch.Tensor  # sum of past per-round delays d_k^tau
    rounds: torch.Tensor  # t (rounds this client participated in)
    n_samples: torch.Tensor  # n'_k — current local data size (online growth)


def state_tree(st: ClientState) -> Tree:
    """The state as one flat ``{"field.leaf" | "field": tensor}`` tree
    (the same tensor objects), for the ``common.pytree`` helpers."""
    out = {f"{f}.{k}": v for f in _TREES for k, v in getattr(st, f).items()}
    out.update({f: getattr(st, f) for f in _SCALARS})
    return out


def state_from_tree(tree: Tree) -> ClientState:
    """Inverse of :func:`state_tree`."""
    kw = {f: {} for f in _TREES}
    for key, v in tree.items():
        f, _, leaf = key.partition(".")
        if leaf:
            kw[f][leaf] = v
        else:
            kw[f] = v
    return ClientState(**kw)


def init_client_state(params: Tree,
                      n_samples: Union[float, torch.Tensor] = 0.0
                      ) -> ClientState:
    """A fresh client state at ``params``.  With ``n_samples`` a ``(R,)``
    tensor the state is stacked: every row starts from the same
    ``params`` with its own sample count."""
    any_leaf = next(iter(params.values()))
    if isinstance(n_samples, torch.Tensor) and n_samples.dim() == 1:
        R = n_samples.shape[0]
        params = {k: v.unsqueeze(0).expand((R,) + v.shape).clone()
                  for k, v in params.items()}
        n = n_samples.to(device=any_leaf.device, dtype=torch.float32)
        zero = torch.zeros(R, dtype=torch.float32, device=any_leaf.device)
    else:
        n = torch.as_tensor(n_samples, dtype=torch.float32,
                            device=any_leaf.device)
        zero = torch.zeros((), dtype=torch.float32, device=any_leaf.device)
    return ClientState(
        params=params,
        server_params={k: v.clone() for k, v in params.items()},
        h=tree_zeros_like(params),
        v=tree_zeros_like(params),
        delay_sum=zero.clone(),
        rounds=zero.clone(),
        n_samples=n.clone(),
    )


def dynamic_multiplier(delay_sum, rounds, new_delay):
    """r_k^t = max(1, log(dbar)) with dbar the running mean delay (Eq. 11)."""
    dbar = (delay_sum + new_delay) / torch.clamp(rounds + 1.0, min=1.0)
    return torch.clamp(torch.log(torch.clamp(dbar, min=1e-6)), min=1.0)


def surrogate_grad(loss_fn: Callable, params: Tree, server_params: Tree,
                   batch, lam: float) -> Tuple[Tree, torch.Tensor, Dict]:
    """grad of s_k = f_k + (lam/2)||w_k - w||^2 at w_k (Eq. 7).

    ``loss_fn(params, batch) -> (loss, metrics)``.  With client-stacked
    params the loss is one value per client; one backward pass of their
    *sum* gives every client its own gradient, because the clients share
    no parameter (each slice of a stacked gradient is that client's).
    """
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(p, batch)
        grads = torch.autograd.grad(loss.sum(), list(p.values()))
    g = {k: gi + lam * (params[k] - server_params[k])
         for k, gi in zip(p, grads)}
    return g, loss.detach(), metrics
