"""FedAsync (Xie et al. 2019) as a cohort-engine strategy.

Local rule: regularized SGD from the client's stale model copy.  Fold
rule: staleness-weighted mixing ``w <- (1-a_t) w + a_t w_k`` with
``a_t = alpha * (1 + staleness)^(-rho)``, applied in arrival order; the
client then downloads the post-fold model and records its version.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import bcast_rows, tree_map, tree_repeat
from repro_torch.core.algorithms.common import (bool_tree, make_state_codec,
                                                sgd_epochs)
from repro_torch.sim.engine import Strategy


def _stale_copies(w0, n0):
    """R stacked rows ``{"w": w0, "version": 0}`` (R = len(n0))."""
    return {"w": tree_repeat(w0, n0.shape[0]),
            "version": torch.zeros_like(n0, dtype=torch.float32)}


def stale_copy_codec(cfg, w0):
    """FedAsync's and FedBuff's state codec: the stale model copies as
    reduced-dtype deltas from w0, the version counter untouched fp32."""
    s0 = torch.zeros((), dtype=torch.float32,
                     device=next(iter(w0.values())).device)
    return make_state_codec(cfg, anchor={"w": w0, "version": s0},
                            mask={"w": bool_tree(w0, True),
                                  "version": False})


class FedAsyncStrategy(Strategy):
    name = "fedasync"
    schedule = "async"

    def build_init_client(self, model, cfg):
        return _stale_copies

    def state_codec(self, model, cfg, w0):
        return stale_copy_codec(cfg, w0)

    def init_server(self, model, cfg_model, cfg, w0, clients, active):
        return {"w": w0}

    def build_local(self, model, cfg):
        sgd = sgd_epochs(model, cfg, mu=0.005)  # FedAsync regularized step

        def local(c, bcast, xs, ys, delay, n_vis, t_arr):
            wk, loss = sgd(c["w"], c["w"], xs, ys)
            return (c, {"wk": wk, "version": c["version"]},
                    {"train_loss": loss})

        return local

    def _mix(self, cfg, t_arr, version):
        staleness = t_arr - version
        return cfg.fedasync_alpha * (1.0 + staleness) ** (
            -cfg.fedasync_staleness_exp)

    def build_fold(self, model, cfg_model, cfg):
        def fold(server, up, idx, n_vis, t_arr):
            alpha_t = self._mix(cfg, t_arr, up["version"])
            w = tree_map(lambda a, b: (1 - alpha_t) * a + alpha_t * b,
                         server["w"], up["wk"])
            return {"w": w}, {"w": w, "version": t_arr + 1.0}

        return fold

    def build_fold_affine(self, model, cfg_model, cfg):
        # the fold is exactly affine in the server weights:
        # w_s = (1 - a_s) w_{s-1} + a_s wk_s, so a = 1 - a_t, b = a_t wk
        def carrier(server):
            return server["w"]

        def coeffs(server, up, idx, n_vis, t_arr, mask):
            alpha_t = self._mix(cfg, t_arr, up["version"])
            alpha_t = torch.where(mask, alpha_t, 0.0)  # padded: identity
            b = tree_map(lambda wk: bcast_rows(alpha_t, wk) * wk, up["wk"])
            return 1.0 - alpha_t, b, None

        def unfold(server, h, aux, up, idx, n_vis, t_arr, mask):
            # every arrival downloads the model as of its own fold; the
            # padded rows of h are reverted at the engine's scatter
            return ({"w": tree_map(lambda x: x[-1], h)},
                    {"w": h, "version": t_arr + 1.0})

        return carrier, coeffs, unfold

    def build_merge(self, model, cfg):
        return lambda c, received: received
