"""Tick layer of the port's cohort engine: the one-tick update and the
window dispatch.

Counterpart of ``repro.sim.compile``.  PyTorch runs eagerly, so nothing
is compiled here: :func:`tick_body` returns a plain function, and
:func:`window_fn` walks a staged window's ticks in a Python loop (each
at its own shape bucket, exactly as a ``window=1`` run dispatches it —
the window-on/off bit-identity contract).  Capturing a window as one
CUDA graph is later work.

One tick ``(stacked, server, arrays, n_real) -> (stacked, server,
tel_row)``:

1. gather the cohort's rows from the stacked client state and, when the
   state is stored through a codec (``RunConfig.state_dtype``), decode
   them to the fp32 working state — the local rounds and the folds see
   fp32 only;
2. run every client's local round at once (batched over the cohort axis);
3. fold the uploads into the server, either
   * **sequentially**, in arrival order, one arrival at a time — only the
     ``n_real`` real arrivals, which fill the first slots of the bucket
     (the host knows how many, so no device value is read back) — or,
     for a strategy with a fused tick fold (ASO-Fed with the feature
     pass: ``kernels.feature_attention.ops.feature_fold``, one kernel
     launch a tick on the card), that fold in one call; or
   * **associatively**, for a strategy with an affine fold form: the
     whole bucket's coefficient stream at once through
     ``kernels.linear_scan.ops.fold_prefix`` (the CUDA kernel on the
     card), padded slots being exact identities (a=1, b=0);
4. merge each client's received model into its state, then apply the
   strategy's finalize (FedAvg's synchronous average);
5. scatter the rows back (in place), encoded again: padded slots target
   the scratch row and write back that row's own pre-tick (still
   encoded) value, so repeated indices are harmless.

``stacked`` is the device-resident ``[K+1, ...]`` stack, or under host
residency the window's block gathered from the pool; only the gather
and the write-back read ``lidx`` (the row in ``stacked``), while the
server reads ``idx`` (the client id), so the arithmetic between them is
the same in both residencies.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.pytree import (tree_map, tree_scatter, tree_take,
                                       tree_where)
from repro_torch.kernels.linear_scan.ops import fold_prefix


def reduce_telemetry(tel, mask: torch.Tensor, slots: Tuple[str, ...]
                     ) -> torch.Tensor:
    """(n_slots,) masked cohort means of the per-client telemetry scalars,
    always at the tick's shape bucket (bit-identical at any window)."""
    if not slots:
        return torch.zeros((0,), dtype=torch.float32, device=mask.device)
    cnt = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    return torch.stack([
        torch.where(mask, tel[s].to(torch.float32), 0.0).sum() / cnt
        for s in slots])


def resolve_fold_affine(strategy, model, cfg_model, cfg,
                        device: torch.device):
    """The affine fold triple to execute this run, or None for the
    sequential arrival-order fold.  Raises on an unknown ``fold_mode``
    and on a forced-associative run whose strategy declines the affine
    form, with ``repro.sim.compile.resolve_fold_affine``'s messages; the
    engine calls it before any work is done.  ``"auto"`` is associative
    only when the strategy has the affine form and the run is on the
    card: on the CPU the sequential fold is the bitwise contract."""
    mode = cfg.fold_mode
    if mode not in ("sequential", "associative", "auto"):
        raise ValueError(
            f"unknown fold_mode {mode!r}; accepted: "
            "'sequential' | 'associative' | 'auto'")
    if mode == "sequential":
        return None
    if strategy.build_fold(model, cfg_model, cfg) is None:
        return None  # no server fold at all: nothing to parallelize
    affine = strategy.build_fold_affine(model, cfg_model, cfg)
    if affine is None:
        if mode == "associative":
            raise ValueError(
                f"fold_mode='associative' but strategy {strategy.name!r} "
                "declines the affine fold form (build_fold_affine returned "
                "None) — use fold_mode='sequential' or 'auto', or drop the "
                "non-affine piece (asofed: feature_learning=False)")
        return None
    if mode == "auto" and device.type == "cpu":
        return None
    return affine


def tick_body(strategy, model, cfg_model, cfg, slots: Tuple[str, ...],
              server_slots: Tuple[str, ...], device: torch.device,
              codec=None):
    """The one-tick update.  The telemetry row is ``slots +
    ("folds_per_tick",) + server_slots``: the strategy's per-client means,
    the engine-owned fold depth, then the post-fold server scalars.
    ``codec``: the strategy's ``ClientStateCodec`` for the stored state,
    or None (fp32 stored as it is)."""
    local = strategy.build_local(model, cfg)
    fold = strategy.build_fold(model, cfg_model, cfg)
    affine = resolve_fold_affine(strategy, model, cfg_model, cfg, device)
    fold_tick = (strategy.build_fold_tick(model, cfg_model, cfg)
                 if fold is not None and affine is None else None)
    merge = strategy.build_merge(model, cfg)
    finalize = strategy.build_finalize(model, cfg)
    server_tel = (strategy.build_server_telemetry(model, cfg)
                  if server_slots else None)

    def tick(stacked, server, arrays, n_real: int):
        idx, lidx, xs, ys, delays, n_vis, t_arr, mask = arrays[:8]
        enc0 = tree_take(stacked, lidx)
        cohort0 = enc0 if codec is None else codec.decode(enc0)
        bcast = strategy.server_broadcast(server)
        cohort, uploads, tel = local(cohort0, bcast, xs, ys, delays, n_vis,
                                     t_arr)
        tel_row = reduce_telemetry(tel, mask, slots)
        if fold is not None and affine is not None:
            carrier, coeffs, unfold = affine
            a_s, b_s, aux = coeffs(server, uploads, idx, n_vis, t_arr, mask)
            h = fold_prefix(a_s, b_s, carrier(server),
                            use_kernel=cfg.fold_kernel)
            server, received = unfold(server, h, aux, uploads, idx, n_vis,
                                      t_arr, mask)
            cohort = merge(cohort, received)
        elif fold_tick is not None and n_real:
            server, received = fold_tick(server, uploads, idx, n_vis, t_arr,
                                         n_real)
            cohort = merge(cohort, received)
        elif fold is not None and n_real:
            received = []
            for s in range(n_real):
                server, rec = fold(server, tree_map(lambda u: u[s], uploads),
                                   idx[s], n_vis[s], t_arr[s])
                received.append(rec)
            # padded slots take a copy of the last real row: their merge
            # is reverted at the scatter below
            pad = (received[-1],) * (mask.shape[0] - n_real)
            cohort = merge(cohort, tree_map(lambda *rs: torch.stack(rs),
                                            *received, *pad))
        if finalize is not None:
            server = finalize(server)
        # engine-owned fold-depth slot + post-fold server scalars
        extras = [mask.to(torch.float32).sum()]
        if server_tel is not None:
            sv_tel = server_tel(server)
            extras += [torch.as_tensor(sv_tel[s], dtype=torch.float32,
                                       device=mask.device).reshape(())
                       for s in server_slots]
        tel_row = torch.cat([tel_row, torch.stack(extras)])
        # padded slots revert to their still-encoded pre-tick rows
        enc = cohort if codec is None else codec.encode(cohort)
        tree_scatter(stacked, lidx, tree_where(mask, enc, enc0))
        return stacked, server, tel_row

    return tick


def window_fn(strategy, model, cfg_model, cfg, slots: Tuple[str, ...],
              server_slots: Tuple[str, ...], device: torch.device, *,
              windowed: bool = True, codec=None):
    """``(stacked, server, pt) -> (stacked, server, tel)`` for one staged
    block.  ``windowed`` (async schedule): the real ticks of ``pt`` in
    order (fully-masked padding ticks of the ``[T_w]`` axis are skipped),
    with a ``[n_ticks, n_slots]`` telemetry block.  Otherwise (sync and
    sweep rounds) ``pt`` is one tick with no window axis; a sweep round
    has no fold, and its ``folds_per_tick`` slot counts the round's
    members (K for Local-S, 1 for Global)."""
    tick = tick_body(strategy, model, cfg_model, cfg, slots, server_slots,
                     device, codec)
    if not windowed:
        return lambda stacked, server, pt: tick(
            stacked, server, pt.arrays, pt.ticks_meta[0].n_folds)

    def run_window(stacked, server, pt):
        rows = []
        for j, tm in enumerate(pt.ticks_meta):
            arrays = tuple(a[j] for a in pt.arrays)
            stacked, server, row = tick(stacked, server, arrays, tm.n_folds)
            rows.append(row)
        return stacked, server, torch.stack(rows)

    return run_window
