"""ASO-Fed central server (paper §4.1, Algorithm 2 lines 3-8), one arrival
at a time.

The server folds in ONE client's update the moment it arrives (Eq. 4):

    w^{t+1} = w^t - (n'_k / N') (w_k^t - w_k^{t+1})

then applies the Eq. (5)-(6) feature pass.  Two faithful formulations:

* ``keep_copies=True`` — the paper's memory layout: the server stores the
  latest copy of every client model and differences it against the upload
  (paper Fig. 2).
* ``keep_copies=False`` — delta mode: clients upload w_k^t - w_k^{t+1}
  directly; mathematically identical, O(1) server memory.

The aggregation arithmetic is fp32.  This is the per-arrival server of
the oracles (``repro_torch.sim.reference``); the cohort engine folds a
whole tick at once (``repro_torch.core.algorithms.asofed``).  On the card
the feature pass is one launch of the per-row CUDA kernel a fold.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.common.pytree import tree_axpy, tree_map, tree_sub
from repro_torch.configs.base import ModelConfig
from repro_torch.core.feature_learning import apply_feature_learning


@dataclasses.dataclass
class ServerState:
    w: Any  # central model (fp32)
    copies: Dict[int, Any]  # latest local copies (paper mode)
    n: Dict[int, float]  # per-client current sample counts n'_k
    t: int = 0  # global iteration counter


def init_server(w, client_ids, n_init: Optional[Dict[int, float]] = None,
                keep_copies: bool = True) -> ServerState:
    copies = ({k: tree_map(torch.clone, w) for k in client_ids}
              if keep_copies else {})
    n = {k: float(n_init[k]) if n_init else 1.0 for k in client_ids}
    return ServerState(w=w, copies=copies, n=n, t=0)


def aggregate(state: ServerState, client_id: int, upload, n_k: float,
              cfg: ModelConfig, *, upload_is_delta: bool = False,
              feature_learning: bool = True,
              use_kernel: Optional[bool] = None) -> ServerState:
    """One asynchronous global iteration (Eq. 4 + Eq. 5-6).

    Fully non-mutating: the input ``state`` (including its ``n`` and
    ``copies`` dicts) is left untouched so callers can keep old states
    for resumable / replayable simulation.  ``use_kernel`` follows
    ``kernels.feature_attention.ops.feature_attention``: None lets the
    device decide (the CUDA kernel on the card, the plain version on the
    CPU).
    """
    n = dict(state.n)
    n[client_id] = float(n_k)
    N = sum(n.values())
    w_any = next(iter(state.w.values()))
    weight = torch.tensor(n_k / max(N, 1e-9), dtype=torch.float32,
                          device=w_any.device)
    copies = state.copies
    if upload_is_delta:
        delta = upload
    else:
        delta = tree_sub(state.copies[client_id], upload)
        copies = dict(state.copies)
        copies[client_id] = upload
    w = tree_axpy(-weight, delta, state.w)  # w - weight * delta, fp32
    if feature_learning:
        w = apply_feature_learning(w, cfg, use_kernel=use_kernel)
    return dataclasses.replace(state, w=w, n=n, copies=copies, t=state.t + 1)
