"""Tick layer of the port's cohort engine: the one-tick update and the
window dispatch.

Counterpart of ``repro.sim.compile`` for the sequential fold.  PyTorch
runs eagerly, so nothing is compiled here: :func:`tick_body` returns a
plain function, and :func:`window_fn` walks a staged window's ticks in a
Python loop (each at its own shape bucket, exactly as a ``window=1`` run
dispatches it — the window-on/off bit-identity contract).  Capturing a
window as one CUDA graph is later work.

One tick ``(stacked, server, arrays, n_real) -> (stacked, server,
tel_row)``:

1. gather the cohort's rows from the stacked client state;
2. run every client's local round at once (batched over the cohort axis);
3. fold the uploads into the server **in arrival order**, one arrival at
   a time — only the ``n_real`` real arrivals, which fill the first
   slots of the bucket (the host knows how many, so no device value is
   read back);
4. merge each client's received model into its state;
5. scatter the rows back (in place): padded slots target the scratch row
   and write back that row's own pre-tick value, so repeated indices are
   harmless.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.common.pytree import tree_scatter, tree_take, tree_where
from repro_torch.core.client import ClientState, state_from_tree, state_tree


def reduce_telemetry(tel, mask: torch.Tensor, slots: Sequence[str]
                     ) -> torch.Tensor:
    """(n_slots,) masked cohort means of the per-client telemetry scalars,
    always at the tick's shape bucket (bit-identical at any window)."""
    if not slots:
        return torch.zeros((0,), dtype=torch.float32, device=mask.device)
    cnt = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    return torch.stack([
        torch.where(mask, tel[s].to(torch.float32), 0.0).sum() / cnt
        for s in slots])


def tick_body(strategy, model, cfg_model, cfg, slots: Tuple[str, ...]):
    """The one-tick update for the async schedule's sequential fold."""
    local = strategy.build_local(model, cfg)
    fold = strategy.build_fold(model, cfg_model, cfg)
    merge = strategy.build_merge(model, cfg)

    def tick(stacked: ClientState, server, arrays, n_real: int):
        idx, lidx, xs, ys, delays, n_vis, t_arr, mask = arrays[:8]
        cohort0 = state_from_tree(tree_take(state_tree(stacked), lidx))
        bcast = strategy.server_broadcast(server)
        cohort, uploads, tel = local(cohort0, bcast, xs, ys, delays, n_vis,
                                     t_arr)
        tel_row = reduce_telemetry(tel, mask, slots)
        if fold is not None and n_real:
            received: List = []
            for s in range(n_real):
                server, rec = fold(
                    server, {k: u[s] for k, u in uploads.items()},
                    idx[s:s + 1], n_vis[s:s + 1], t_arr[s:s + 1])
                received.append(rec)
            # padded slots keep their own params (reverted below anyway)
            rec_rows = {k: torch.cat([torch.stack([r[k] for r in received]),
                                      cohort.params[k][n_real:]])
                        for k in received[0]}
            cohort = merge(cohort, rec_rows)
        # engine-owned fold-depth slot
        tel_row = torch.cat([tel_row,
                             mask.to(torch.float32).sum().reshape(1)])
        tree_scatter(state_tree(stacked), lidx,
                     tree_where(mask, state_tree(cohort), state_tree(cohort0)))
        return stacked, server, tel_row

    return tick


def window_fn(strategy, model, cfg_model, cfg, slots: Tuple[str, ...]):
    """``(stacked, server, pt) -> (stacked, server, tel_block)`` for one
    staged window: the real ticks of ``pt`` in order (fully-masked padding
    ticks of the ``[T_w]`` axis are skipped), with a ``[n_ticks,
    n_slots]`` telemetry block."""
    tick = tick_body(strategy, model, cfg_model, cfg, slots)

    def run_window(stacked, server, pt):
        rows = []
        for j, tm in enumerate(pt.ticks_meta):
            arrays = tuple(a[j] for a in pt.arrays)
            stacked, server, row = tick(stacked, server, arrays, tm.n_folds)
            rows.append(row)
        return stacked, server, torch.stack(rows)

    return run_window
