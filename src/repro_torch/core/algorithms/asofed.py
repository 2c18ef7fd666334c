"""ASO-Fed as a cohort-engine strategy (the paper's algorithm, Eq. 4-11).

Local rule: the Eq. (7)-(11) online update (surrogate grad averaged over E
minibatches, decay-corrected direction, dynamic step multiplier), for a
whole cohort at once.  Fold rule: the Eq. (4) sequential server recurrence
followed by the Eq. (5)-(6) feature pass, one arrival at a time; each
client downloads the central model as of its own fold.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.pytree import tree_axpy, tree_sub
from repro_torch.core import client as client_lib
from repro_torch.core.algorithms.common import avg_surrogate_grad
from repro_torch.core.feature_learning import apply_feature_learning
from repro_torch.sim.engine import Strategy


class AsoFedStrategy(Strategy):
    name = "asofed"
    schedule = "async"

    def telemetry_slots(self, cfg):
        # the Eq. (11) dynamic step multiplier rides along with the
        # surrogate loss: both are already computed by the local round
        return ("train_loss", "step_mult")

    def init_client(self, model, cfg, w0, client):
        n0 = float(client.stream.visible(0)) if client is not None else 0.0
        return client_lib.init_client_state(w0, n0)

    def build_init_client(self, model, cfg):
        # batched stacked init: (w0, n0 of shape (R,)) -> R stacked rows
        return lambda w0, n0: client_lib.init_client_state(w0, n0)

    def init_server(self, model, cfg_model, cfg, w0, clients, active):
        # per-client online sample counts n'_k, indexed by cid; one extra
        # scratch slot absorbs padded-slot writes.  Dropped clients hold 0
        # so N' sums over responsive clients only.
        n = np.zeros(len(clients) + 1, np.float32)
        for c in active:
            n[c.cid] = c.stream.visible(0)
        dev = next(iter(w0.values())).device
        return {"w": w0, "n": torch.tensor(n, device=dev)}

    def build_local(self, model, cfg):
        grad_fn = avg_surrogate_grad(model, cfg)

        def local(st, bcast, xs, ys, delay, n_vis, t_arr):
            g, loss = grad_fn(st.params, st.server_params, xs, ys)
            # Eq. (8): variance-corrected direction
            zeta = {k: g[k] - st.v[k] + st.h[k] for k in g}
            if cfg.dynamic_lr:
                r = client_lib.dynamic_multiplier(st.delay_sum, st.rounds,
                                                  delay)
            else:
                r = torch.ones_like(delay)
            new_params = tree_axpy(-r * cfg.eta, zeta, st.params)
            # Eq. (9) / Alg. 2 line 15: slot update with the previous v
            new_h = {k: cfg.beta * st.h[k] + (1 - cfg.beta) * st.v[k]
                     for k in st.h}
            n_new = torch.clamp(n_vis - st.n_samples, min=0.0)
            st2 = client_lib.ClientState(
                params=new_params, server_params=st.server_params,
                h=new_h, v=g,
                delay_sum=st.delay_sum + delay, rounds=st.rounds + 1.0,
                n_samples=st.n_samples + n_new,
            )
            tel = {"train_loss": loss, "step_mult": r}
            return st2, tree_sub(st.params, new_params), tel  # upload: delta

        return local

    def build_fold(self, model, cfg_model, cfg):
        def fold(server, delta, idx, n_vis, t_arr):
            # one arrival: idx / n_vis / t_arr are 1-element tensors, so
            # the count update and the weight stay on the device
            n = server["n"].index_copy(0, idx, n_vis)
            weight = n_vis / torch.clamp(n.sum(), min=1e-9)  # n'_k / N'
            w = tree_axpy(-weight, delta, server["w"])  # Eq. (4)
            if cfg.feature_learning:
                # Eq. (5)-(6): the CUDA kernel on the card, one launch
                w = apply_feature_learning(w, cfg_model,
                                           use_kernel=cfg.feature_kernel)
            return {"w": w, "n": n}, w

        return fold

    def build_merge(self, model, cfg):
        def merge(st, w_received):
            # the client pulls the fresh central model for its next round
            return dataclasses.replace(
                st, params=w_received, server_params=w_received)

        return merge
