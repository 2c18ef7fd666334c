"""Local-S and Global baselines as cohort-engine strategies.

Local-S: every client trains its own model, no server — the sweep
schedule runs all clients each round in one batched call and evaluation
uses the stacked per-client parameters.  Global: all data pooled on one
machine (upper-bound-ish baseline) — a single virtual member whose batch
is drawn across every client's stream.

Neither has a server fold, so neither reaches the feature pass (K1) or
the fold's linear recurrence (K2).  Local-S draws client k's start from
``torch.Generator().manual_seed(seed + k)``, where the JAX package draws
``PRNGKey(seed + k)``: the values differ, so a run that must match the
JAX package passes its per-client draws through ``init_params``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithms.common import sgd_epochs
from repro_torch.sim.engine import Strategy, pad_batch


def _build_sgd_local(model, cfg):
    sgd = sgd_epochs(model, cfg)

    def local(c, bcast, xs, ys, delay, n_vis, t_arr):
        wk, loss = sgd(c["w"], c["w"], xs, ys)
        return {"w": wk}, torch.zeros_like(loss), {"train_loss": loss}

    return local


class LocalStrategy(Strategy):
    # no server fold at all (build_fold is None), so every fold_mode
    # degrades to "nothing to parallelize" for both baselines
    name = "local"
    schedule = "sweep"
    uses_dropout = False
    eval_per_client = True
    per_client_init = True

    def init_client(self, model, cfg, w0, client, start=None):
        """Client ``client``'s own start: ``start`` when the run was given
        per-client weights, else a draw from ``seed + cid``."""
        if start is not None:
            return {"w": start}
        cid = client.cid if client is not None else 0
        dev = next(iter(w0.values())).device
        return {"w": model.init(
            torch.Generator().manual_seed(cfg.seed + cid), device=dev)}

    def build_local(self, model, cfg):
        return _build_sgd_local(model, cfg)

    def eval_params(self, server, stacked_clients=None):
        return stacked_clients["w"]


class GlobalStrategy(Strategy):
    name = "global"
    schedule = "sweep"
    uses_dropout = False
    pooled = True

    def init_client(self, model, cfg, w0, client):
        return {"w": w0}

    def build_local(self, model, cfg):
        return _build_sgd_local(model, cfg)

    def pooled_batches(self, clients, t, cfg):
        """Fixed-size global minibatches drawn across every client."""
        B = cfg.batch_size
        xs_all, ys_all = [], []
        for c in clients:
            x, y = c.stream.batch(t, B)
            xs_all.append(x)
            ys_all.append(y)
        c0 = clients[0].stream
        x, y = pad_batch(np.concatenate(xs_all), np.concatenate(ys_all),
                         B * 4, c0.x, c0.y)
        return (x.reshape(4, B, *x.shape[1:]),
                y.reshape(4, B, *y.shape[1:]))

    def eval_params(self, server, stacked_clients=None):
        return {k: v[0] for k, v in stacked_clients["w"].items()}
