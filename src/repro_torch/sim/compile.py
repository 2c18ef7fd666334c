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
   fp32 only; under faults, a client rejoining after a crash starts from
   a freshly initialized row;
2. run every client's local round at once (batched over the cohort axis);
   then, under the chaos layer, pass each slot's wire delta through the
   upload codec and the payload corruption, and decide its admission
   (non-finite deltas, ``max_staleness``, ``max_delta_norm``) as per-slot
   masks and scales on the device;
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
4. merge each client's received model into its state (an arrival the
   guards rejected receives nothing), then apply the strategy's finalize
   (FedAvg's synchronous average);
5. scatter the rows back (in place), encoded again: padded slots target
   the scratch row and write back that row's own pre-tick (still
   encoded) value, so repeated indices are harmless.

``stacked`` is the device-resident ``[K+1, ...]`` stack, or under host
residency the window's block gathered from the pool; only the gather
and the write-back read ``lidx`` (the row in ``stacked``), while the
server reads ``idx`` (the client id), so the arithmetic between them is
the same in both residencies.

The chaos layer (``repro.sim.compile.tick_body``'s): the tick reads the
four chaos columns (``fresh`` / ``dup`` / ``corrupt`` / ``stal``) only
when the run has faults, admission guards or a lossy upload codec, so a
run with none of them executes the ops it executed before the layer
existed and replays bit for bit.  Every admission decision stays on the
device: the sequential folds take it as a mask (and as the fused fold's
per-slot count), the associative one as identity coefficients, and no
device value is read back on the host inside a tick.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common import prng
from repro_torch.common.pytree import (bcast_rows, tree_map, tree_scatter,
                                       tree_take, tree_where)
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
                        device: torch.device, *, faults_on: bool = False):
    """The affine fold triple to execute this run, or None for the
    sequential arrival-order fold.  Raises on an unknown ``fold_mode``
    and on a forced-associative run whose strategy declines the affine
    form, with ``repro.sim.compile.resolve_fold_affine``'s messages; the
    engine calls it before any work is done.  ``"auto"`` is associative
    only when the strategy has the affine form and the run is on the
    card: on the CPU the sequential fold is the bitwise contract.
    ``faults_on``: the closed form must also stay exact under duplicate
    and rejected arrivals (``Strategy.fold_affine_supports_faults``); a
    declining strategy (fedbuff) folds sequentially under ``"auto"`` and
    raises under ``"associative"``."""
    mode = cfg.fold_mode
    if mode not in ("sequential", "associative", "auto"):
        raise ValueError(
            f"unknown fold_mode {mode!r}; accepted: "
            "'sequential' | 'associative' | 'auto'")
    if mode == "sequential":
        return None
    if strategy.build_fold(model, cfg_model, cfg) is None:
        return None  # no server fold at all: nothing to parallelize
    if faults_on and not strategy.fold_affine_supports_faults:
        if mode == "associative":
            raise ValueError(
                f"fold_mode='associative' with fault injection, but "
                f"strategy {strategy.name!r} declares its affine fold form "
                "inexact under duplicate/rejected arrivals "
                "(fold_affine_supports_faults=False) — use "
                "fold_mode='sequential' or 'auto'")
        return None
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


def chaos_tick(strategy, model, cfg_model, cfg, faults_on: bool) -> bool:
    """Whether the run's ticks carry the chaos layer's guards (faults or
    an admission knob): they need a fold to guard and a wire delta to
    inspect, so the sweep baselines, which have neither, never do."""
    return ((faults_on or cfg.max_staleness is not None
             or cfg.max_delta_norm is not None)
            and strategy.build_fold(model, cfg_model, cfg) is not None
            and strategy.upload_codec_view(model, cfg) is not None)


def tick_body(strategy, model, cfg_model, cfg, slots: Tuple[str, ...],
              server_slots: Tuple[str, ...], device: torch.device,
              codec=None, *, faults_on: bool = False, w0=None):
    """The one-tick update.  The telemetry row is ``slots +
    ("folds_per_tick",) + server_slots``: the strategy's per-client means,
    the engine-owned fold depth, then the post-fold server scalars; a
    chaos tick appends the ``rejected`` / ``clipped`` admission counts.
    ``codec``: the strategy's ``ClientStateCodec`` for the stored state,
    or None (fp32 stored as it is).  ``faults_on``: some client carries
    an active ``FaultSpec``; ``w0``: the run's starting weights, from
    which a crashed client's row is rebuilt."""
    # imported here: the strategy modules import the engine, which
    # imports this module
    from repro_torch.core.algorithms.common import (admission,
                                                    corrupt_wire_delta,
                                                    corruption_key,
                                                    resolve_upload_codec,
                                                    upload_keys)

    local = strategy.build_local(model, cfg)
    fold = strategy.build_fold(model, cfg_model, cfg)
    affine = resolve_fold_affine(strategy, model, cfg_model, cfg, device,
                                 faults_on=faults_on)
    fold_tick = (strategy.build_fold_tick(model, cfg_model, cfg)
                 if fold is not None and affine is None else None)
    merge = strategy.build_merge(model, cfg)
    finalize = strategy.build_finalize(model, cfg)
    server_tel = (strategy.build_server_telemetry(model, cfg)
                  if server_slots else None)
    ucodec = resolve_upload_codec(cfg)
    uview = strategy.upload_codec_view(model, cfg)
    chaos = chaos_tick(strategy, model, cfg_model, cfg, faults_on)
    if not ucodec.identity and uview is None:
        raise ValueError(
            f"upload_codec={ucodec.name!r} requires an upload_codec_view "
            f"from strategy {strategy.name!r}")
    # the wire pass: the lossy codec, then (under faults) the corruption
    wire = not ucodec.identity or (faults_on and chaos)
    init_one = strategy.build_init_client(model, cfg) if faults_on else None
    # the run's PRNG key on the device, made once: the per-slot keys
    # derive from it without a host copy
    key0 = prng.prng_key(cfg.seed, device) if wire else None

    def wire_pass(uploads, cohort0, bcast, idx, t_arr, corrupt):
        """Each slot's upload after its wire delta went through the codec
        and the corruption (JAX's ``encode_one`` over the cohort)."""
        extract, rebuild = uview
        d = extract(uploads, cohort0, bcast)
        if not ucodec.identity:
            d = ucodec.encode(d, upload_keys(key0, t_arr, idx)
                              if ucodec.uses_rng else None)
        if faults_on:
            d = corrupt_wire_delta(d, corrupt,
                                   corruption_key(key0, t_arr, idx))
        up2 = rebuild(uploads, d, cohort0, bcast)
        if ucodec.identity:
            # clean arrivals stay bitwise: the extract / rebuild round trip
            # may reassociate
            return tree_where(corrupt > 0, up2, uploads)
        return up2

    def guard(uploads, cohort0, bcast, stal):
        """(ok, scale, uploads'): each slot's admission; rejected or
        rescaled slots are rebuilt from sanitized deltas (zeros / scaled),
        admitted unscaled uploads pass through bitwise."""
        extract, rebuild = uview
        d = extract(uploads, cohort0, bcast)
        ok, sc = admission(d, stal, cfg)
        d2 = tree_map(lambda x: torch.where(
            bcast_rows(ok, x), x * bcast_rows(sc, x), 0.0), d)
        up2 = rebuild(uploads, d2, cohort0, bcast)
        return ok, sc, tree_where(ok & (sc >= 1.0), uploads, up2)

    def tick(stacked, server, arrays, n_real: int):
        (idx, lidx, xs, ys, delays, n_vis, t_arr, mask, fresh, dup, corrupt,
         stal) = arrays
        enc0 = tree_take(stacked, lidx)
        cohort0 = enc0 if codec is None else codec.decode(enc0)
        if init_one is not None:
            # crash-restart: a rejoining client's round starts from a fresh
            # row (n_vis: its stream's visible count at rejoin)
            cohort0 = tree_where(fresh & mask, init_one(w0, n_vis), cohort0)
        bcast = strategy.server_broadcast(server)
        cohort, uploads, tel = local(cohort0, bcast, xs, ys, delays, n_vis,
                                     t_arr)
        if wire:
            uploads = wire_pass(uploads, cohort0, bcast, idx, t_arr,
                                corrupt)
        admit = mask
        if chaos:
            ok, sc, uploads = guard(uploads, cohort0, bcast, stal)
            admit = mask & ok
            clipped = admit & (sc < 1.0)
        tel_row = reduce_telemetry(tel, mask, slots)
        received = None
        if fold is not None and affine is not None:
            carrier, coeffs, unfold = affine
            # rejected slots are identities by the coeffs contract
            a_s, b_s, aux = coeffs(server, uploads, idx, n_vis, t_arr,
                                   admit)
            if faults_on:
                # a duplicated slot folds twice: its affine map composed
                # with itself, a' = a^2, b' = a b + b
                dd = admit & dup
                b_s = tree_where(dd, tree_map(
                    lambda b: bcast_rows(a_s, b) * b + b, b_s), b_s)
                a_s = torch.where(dd, a_s * a_s, a_s)
            h = fold_prefix(a_s, b_s, carrier(server),
                            use_kernel=cfg.fold_kernel)
            server, received = unfold(server, h, aux, uploads, idx, n_vis,
                                      t_arr, admit)
        elif fold_tick is not None and n_real:
            if chaos:
                # each slot's fold count on the device: 0 rejected, 1, or
                # 2 for a duplicated delivery
                reps = admit.to(torch.int32) * (1 + dup.to(torch.int32))
                server, received = fold_tick(server, uploads, idx, n_vis,
                                             t_arr, n_real, reps=reps)
            else:
                server, received = fold_tick(server, uploads, idx, n_vis,
                                             t_arr, n_real)
        elif fold is not None and n_real:
            received = []
            for s in range(n_real):
                up = tree_map(lambda u: u[s], uploads)
                sv, rec = fold(server, up, idx[s], n_vis[s], t_arr[s])
                if faults_on:
                    # duplicate delivery folds the same upload again; the
                    # client downloads the model after the second fold
                    sv2, rec2 = fold(sv, up, idx[s], n_vis[s], t_arr[s])
                    dd = admit[s] & dup[s]
                    sv = tree_where(dd, sv2, sv)
                    rec = tree_where(dd, rec2, rec)
                # a rejected slot leaves the server untouched
                server = tree_where(admit[s], sv, server) if chaos else sv
                received.append(rec)
            # padded slots take a copy of the last real row: their merge
            # is reverted at the scatter below
            pad = (received[-1],) * (mask.shape[0] - n_real)
            received = tree_map(lambda *rs: torch.stack(rs), *received,
                                *pad)
        if received is not None:
            if chaos:
                # a rejected client keeps its post-round state and
                # downloads nothing
                cohort = tree_where(admit, merge(cohort, received), cohort)
            else:
                cohort = merge(cohort, received)
        if finalize is not None:
            server = finalize(server)
        # engine-owned fold-depth slot + post-fold server scalars
        extras = [mask.to(torch.float32).sum()]
        if server_tel is not None:
            sv_tel = server_tel(server)
            extras += [torch.as_tensor(sv_tel[s], dtype=torch.float32,
                                       device=mask.device).reshape(())
                       for s in server_slots]
        if chaos:
            # the per-tick admission counts (the engine totals them)
            extras += [(mask & ~admit).to(torch.float32).sum(),
                       clipped.to(torch.float32).sum()]
        tel_row = torch.cat([tel_row, torch.stack(extras)])
        # padded slots revert to their still-encoded pre-tick rows
        enc = cohort if codec is None else codec.encode(cohort)
        tree_scatter(stacked, lidx, tree_where(mask, enc, enc0))
        return stacked, server, tel_row

    return tick


def window_fn(strategy, model, cfg_model, cfg, slots: Tuple[str, ...],
              server_slots: Tuple[str, ...], device: torch.device, *,
              windowed: bool = True, codec=None, faults_on: bool = False,
              w0=None):
    """``(stacked, server, pt) -> (stacked, server, tel)`` for one staged
    block.  ``windowed`` (async schedule): the real ticks of ``pt`` in
    order (fully-masked padding ticks of the ``[T_w]`` axis are skipped),
    with a ``[n_ticks, n_slots]`` telemetry block.  Otherwise (sync and
    sweep rounds) ``pt`` is one tick with no window axis; a sweep round
    has no fold, and its ``folds_per_tick`` slot counts the round's
    members (K for Local-S, 1 for Global)."""
    tick = tick_body(strategy, model, cfg_model, cfg, slots, server_slots,
                     device, codec, faults_on=faults_on, w0=w0)
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
