"""FedAvg / FedProx as cohort-engine strategies (synchronous baselines).

Local rule: E (prox-)SGD epochs from the broadcast central model.  Fold
rule: accumulate sample-weighted sums; the tick finalize applies the
synchronous weighted average (order-free, so arrival order is irrelevant).
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import (bcast_rows, tree_map, tree_repeat,
                                       tree_zeros_like)
from repro_torch.core.algorithms.common import sgd_epochs
from repro_torch.sim.engine import Strategy


class FedAvgStrategy(Strategy):
    name = "fedavg"
    schedule = "sync"

    def mu(self, cfg) -> float:
        return 0.0

    def init_client(self, model, cfg, w0, client):
        return {}  # stateless: clients restart from the broadcast model

    def init_server(self, model, cfg_model, cfg, w0, clients, active):
        dev = next(iter(w0.values())).device
        return {"w": w0, "acc": tree_zeros_like(w0),
                "tot": torch.zeros((), dtype=torch.float32, device=dev)}

    def server_broadcast(self, server):
        return server["w"]

    def upload_codec_view(self, model, cfg):
        # the upload is the full local model; its wire delta is measured
        # against the round's broadcast
        def extract(wk, c0, bcast):
            return tree_map(torch.sub, wk, bcast)

        def rebuild(wk, d, c0, bcast):
            return tree_map(torch.add, bcast, d)

        return extract, rebuild

    def build_local(self, model, cfg):
        sgd = sgd_epochs(model, cfg, mu=self.mu(cfg))

        def local(c, w_bcast, xs, ys, delay, n_vis, t_arr):
            w = tree_repeat(w_bcast, xs.shape[0])
            wk, loss = sgd(w, w, xs, ys)
            return c, wk, {"train_loss": loss}

        return local

    def build_fold(self, model, cfg_model, cfg):
        def fold(server, wk, idx, n_vis, t_arr):
            acc = tree_map(lambda a, b: a + n_vis * b, server["acc"], wk)
            return ({"w": server["w"], "acc": acc,
                     "tot": server["tot"] + n_vis}, torch.zeros_like(n_vis))

        return fold

    def build_fold_affine(self, model, cfg_model, cfg):
        # the accumulate fold is a plain prefix sum (a = 1) over the
        # sample-weighted uploads; the central model rides outside the
        # recurrence and finalize applies the synchronous average
        def carrier(server):
            return {"acc": server["acc"], "tot": server["tot"]}

        def coeffs(server, wk, idx, n_vis, t_arr, mask):
            nv = torch.where(mask, n_vis, 0.0)
            b = {"acc": tree_map(lambda x: bcast_rows(nv, x) * x, wk),
                 "tot": nv}
            return torch.ones_like(nv), b, None

        def unfold(server, h, aux, wk, idx, n_vis, t_arr, mask):
            server2 = {"w": server["w"],
                       "acc": tree_map(lambda x: x[-1], h["acc"]),
                       "tot": h["tot"][-1]}
            return server2, torch.zeros_like(n_vis)

        return carrier, coeffs, unfold

    def build_finalize(self, model, cfg):
        def finalize(server):
            tot = server["tot"]
            has = tot > 0  # all participants skipped: keep the old model
            w = tree_map(lambda a, wp: torch.where(
                has, a / torch.clamp(tot, min=1e-9), wp),
                server["acc"], server["w"])
            return {"w": w, "acc": tree_zeros_like(w),
                    "tot": torch.zeros_like(tot)}

        return finalize


class FedProxStrategy(FedAvgStrategy):
    name = "fedprox"

    def mu(self, cfg) -> float:
        return cfg.prox_mu or 0.01
