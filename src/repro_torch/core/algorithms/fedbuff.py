"""FedBuff-style buffered asynchronous aggregation as a cohort strategy.

Every arrival deposits a staleness-weighted delta (weight
``1/sqrt(1 + staleness)``) into a server-side buffer; when the buffer
holds ``RunConfig.buffer_size`` (M) contributions the server applies ONE
step ``w <- w - fedbuff_lr/M * buf`` and clears it.  Clients always
download the current central model.  Local rule: plain E-epoch SGD from
the client's stale copy; the upload is the pre-minus-post delta plus the
copy's version.

Under ``fold_mode="associative"`` the whole tick is one prefix scan with
a = 1 throughout: the buffer is a masked prefix sum, the flush points a
running max over crossing indices, and ``b_s`` is nonzero only at flush
arrivals (:meth:`FedBuffStrategy.build_fold_affine`).
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import (bcast_rows, tree_axpy, tree_map,
                                       tree_sub, tree_where, tree_zeros_like)
from repro_torch.core.algorithms.common import sgd_epochs
from repro_torch.core.algorithms.fedasync import (_stale_copies,
                                                  stale_copy_codec)
from repro_torch.sim.engine import Strategy


class FedBuffStrategy(Strategy):
    name = "fedbuff"
    schedule = "async"
    # the flush closed form assumes exactly one fold per real arrival
    fold_affine_supports_faults = False

    def server_telemetry_slots(self, cfg):
        # post-tick buffer occupancy (0..M-1)
        return ("buffer_fill",)

    def build_server_telemetry(self, model, cfg):
        return lambda server: {"buffer_fill": server["count"]}

    def build_init_client(self, model, cfg):
        return _stale_copies

    def state_codec(self, model, cfg, w0):
        # the same layout as fedasync's
        return stale_copy_codec(cfg, w0)

    def init_server(self, model, cfg_model, cfg, w0, clients, active):
        if cfg.buffer_size < 1:
            raise ValueError(
                f"RunConfig.buffer_size must be >= 1, got {cfg.buffer_size}")
        dev = next(iter(w0.values())).device
        return {"w": w0, "buf": tree_zeros_like(w0),
                "count": torch.zeros((), dtype=torch.float32, device=dev)}

    def build_local(self, model, cfg):
        sgd = sgd_epochs(model, cfg, mu=0.0)

        def local(c, bcast, xs, ys, delay, n_vis, t_arr):
            wk, loss = sgd(c["w"], c["w"], xs, ys)
            return (c, {"delta": tree_sub(c["w"], wk),
                        "version": c["version"]}, {"train_loss": loss})

        return local

    def build_fold(self, model, cfg_model, cfg):
        M = float(cfg.buffer_size)

        def fold(server, up, idx, n_vis, t_arr):
            s_w = 1.0 / torch.sqrt(1.0 + (t_arr - up["version"]))
            buf = tree_axpy(s_w, up["delta"], server["buf"])
            count = server["count"] + 1.0
            flush = count >= M
            w = tree_where(flush,
                           tree_axpy(-cfg.fedbuff_lr / M, buf, server["w"]),
                           server["w"])
            buf = tree_where(flush, tree_zeros_like(buf), buf)
            count = torch.where(flush, 0.0, count)
            return ({"w": w, "buf": buf, "count": count},
                    {"w": w, "version": t_arr + 1.0})

        return fold

    def build_fold_affine(self, model, cfg_model, cfg):
        M = float(cfg.buffer_size)
        scale = cfg.fedbuff_lr / M

        def carrier(server):
            return server["w"]

        def coeffs(server, up, idx, n_vis, t_arr, mask):
            m32 = mask.to(torch.float32)
            S = m32.shape[0]
            # padded slots weigh 0 whatever their row holds: under host
            # residency a padded slot reads a real client's row, whose
            # version can exceed the padded t_arr of 0 (the sqrt of a
            # negative is NaN, and 0 / NaN is NaN)
            s_w = torch.where(
                mask, 1.0 / torch.sqrt(1.0 + (t_arr - up["version"])), 0.0)
            # c_s: cumulative fold count ignoring resets.  The stored
            # count sits in [0, M-1], so a flush fires at exactly the
            # real arrivals whose c_s crosses a multiple of M.
            c_s = server["count"] + torch.cumsum(m32, dim=0)
            flush = mask & (torch.remainder(c_s, M) == 0.0)
            sidx = torch.arange(S, device=mask.device)
            lf = torch.cummax(torch.where(flush, sidx, -1), dim=0).values
            take = torch.clamp(lf, min=0)  # last flush <= s
            live = (lf >= 0).to(torch.float32)  # 0 until the first flush

            # W_s: buffer content ignoring resets; the server weight after
            # fold s is w_0 - scale * W_{lf(s)}, so b_s is the (scaled)
            # jump of W_lf — nonzero only at flush arrivals
            W = tree_map(lambda d, buf0: buf0.unsqueeze(0) + torch.cumsum(
                bcast_rows(s_w, d) * d, dim=0), up["delta"], server["buf"])
            Wlf = tree_map(lambda Wl: bcast_rows(live, Wl)
                           * Wl.index_select(0, take), W)
            b = tree_map(lambda Wl: -scale * torch.diff(
                Wl, dim=0, prepend=torch.zeros_like(Wl[:1])), Wlf)
            # post-tick byproducts: what survived the last flush
            buf_new = tree_map(lambda Wl, Wf: Wl[-1] - Wf[-1], W, Wlf)
            count_new = torch.remainder(c_s[-1], M)
            return torch.ones_like(m32), b, (buf_new, count_new)

        def unfold(server, h, aux, up, idx, n_vis, t_arr, mask):
            buf_new, count_new = aux
            server2 = {"w": tree_map(lambda x: x[-1], h), "buf": buf_new,
                       "count": count_new}
            return server2, {"w": h, "version": t_arr + 1.0}

        return carrier, coeffs, unfold

    def build_merge(self, model, cfg):
        # the client downloads the central model as of its own fold
        return lambda c, received: received
