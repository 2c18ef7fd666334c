"""ASO-Fed as a cohort-engine strategy (the paper's algorithm, Eq. 4-11).

Local rule: the Eq. (7)-(11) online update (surrogate grad averaged over E
minibatches, decay-corrected direction, dynamic step multiplier), for a
whole cohort at once.  Fold rule: the Eq. (4) sequential server recurrence
followed by the Eq. (5)-(6) feature pass, one arrival at a time; each
client downloads the central model as of its own fold.  With the feature
pass the engine folds a whole tick at once (``build_fold_tick``: one
fused kernel launch on the card, the same per-arrival loop on the CPU).
Without it (ASO-Fed(-F)) the fold is affine and also runs as one prefix
scan per tick (``build_fold_affine``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.pytree import (bcast_rows, tree_axpy, tree_map,
                                       tree_sub, tree_zeros_like)
from repro_torch.core import client as client_lib
from repro_torch.core.algorithms.common import (avg_surrogate_grad,
                                                bool_tree, make_state_codec)
from repro_torch.core.feature_learning import (apply_feature_learning,
                                               first_layer_path)
from repro_torch.kernels.feature_attention.ops import feature_fold
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

    def state_codec(self, model, cfg, w0):
        # params / server_params stored as reduced-dtype deltas from w0
        # (constant over the run), h / v as plain reduced casts (zero
        # anchor); the delay / round / sample scalars pass through in
        # fp32, where reduced mantissas would corrupt their counting
        z = tree_zeros_like(w0)
        s0 = torch.zeros((), dtype=torch.float32,
                         device=next(iter(w0.values())).device)
        anchor = client_lib.ClientState(
            params=w0, server_params=w0, h=z, v=z,
            delay_sum=s0, rounds=s0, n_samples=s0)
        mask = client_lib.ClientState(
            params=bool_tree(w0, True), server_params=bool_tree(w0, True),
            h=bool_tree(z, True), v=bool_tree(z, True),
            delay_sum=False, rounds=False, n_samples=False)
        return make_state_codec(cfg, anchor, mask)

    def upload_codec_view(self, model, cfg):
        # the upload IS the wire delta (params - new_params): the codec
        # round-trips it in place
        return (lambda up, c0, bcast: up,
                lambda up, d, c0, bcast: d)

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
            # one arrival: idx / n_vis / t_arr are 0-d tensors, so the
            # count update and the weight stay on the device
            n = server["n"].index_copy(0, idx.reshape(1), n_vis.reshape(1))
            weight = n_vis / torch.clamp(n.sum(), min=1e-9)  # n'_k / N'
            w = tree_axpy(-weight, delta, server["w"])  # Eq. (4)
            if cfg.feature_learning:
                # Eq. (5)-(6): the CUDA kernel on the card, one launch
                w = apply_feature_learning(w, cfg_model,
                                           use_kernel=cfg.feature_kernel)
            return {"w": w, "n": n}, w

        return fold

    def build_fold_tick(self, model, cfg_model, cfg):
        # build_fold over a whole tick: one launch on the card
        if not cfg.feature_learning:
            return None
        first = first_layer_path(cfg_model)

        def fold_tick(server, delta, idx, n_vis, t_arr, n_real, reps=None):
            w, n, received = feature_fold(server["w"], delta, first,
                                          server["n"], idx, n_vis, n_real,
                                          use_kernel=cfg.feature_kernel,
                                          reps=reps)
            return {"w": w, "n": n}, received

        return fold_tick

    def build_fold_affine(self, model, cfg_model, cfg):
        # Eq. (4) alone is affine in w with a = 1 (a weighted-delta
        # subtraction); the Eq. (5)-(6) feature pass is NOT affine, so
        # ASO-Fed only qualifies with feature_learning off (ASO-Fed(-F))
        if cfg.feature_learning:
            return None

        def carrier(server):
            return server["w"]

        def coeffs(server, delta, idx, n_vis, t_arr, mask):
            m32 = mask.to(torch.float32)
            n0 = server["n"]
            n_old = n0.index_select(0, idx)
            # tick clients are pairwise distinct, so each fold's count
            # update is a pure replacement: the running total N'_s after
            # fold s is sum(n0) plus the cumulative masked increments
            # (inclusive: the sequential fold counts its own client)
            Ns = n0.sum() + torch.cumsum(m32 * (n_vis - n_old), dim=0)
            weight = torch.where(mask, n_vis / torch.clamp(Ns, min=1e-9),
                                 0.0)
            b = tree_map(lambda d: bcast_rows(-weight, d) * d, delta)
            # the post-tick count vector.  Every padded slot targets the
            # scratch row and writes back that row's own old value, and
            # real slots are pairwise distinct, so the repeated scratch
            # index is harmless whatever order the writes land in
            n_new = n0.index_put((idx,), torch.where(mask, n_vis, n_old))
            return torch.ones_like(weight), b, n_new

        def unfold(server, h, n_new, delta, idx, n_vis, t_arr, mask):
            return {"w": tree_map(lambda x: x[-1], h), "n": n_new}, h

        return carrier, coeffs, unfold

    def build_merge(self, model, cfg):
        def merge(st, w_received):
            # the client pulls the fresh central model for its next round
            return dataclasses.replace(
                st, params=w_received, server_params=w_received)

        return merge
