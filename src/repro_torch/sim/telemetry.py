"""In-scan telemetry for the cohort engine: per-tick curves at any window.

The megastep fused ``RunConfig.window`` ticks into one dispatch —
and with it, coarsened every host-visible signal to window boundaries
(the ROADMAP "windowed eval extraction" item).  This module restores
per-tick resolution without giving the fusion back:

* each dispatched tick emits one **telemetry row** — the masked cohort
  means of the per-client scalars the strategy's ``local`` computes
  anyway (train loss, step multipliers, ...; see
  ``Strategy.telemetry_slots``) — stacked by the window dispatch into a
  ``[T_w, n_slots]`` device block: zero extra transfers, zero syncs;
* the TickBuilder records per-tick **host metadata** (fold counts, staleness
  sums, arrival times: ``repro_torch.sim.prefetch.TickMeta``) on the producer
  thread, for free;
* :class:`TelemetryLog` joins the two — device blocks are kept un-read
  until :meth:`finalize` (end of run, same policy as the engine's
  deferred eval extraction), then materialized once into
  :class:`TickRecord` rows.

Because a tick always executes at its unfused shape bucket, its telemetry
row is **bit-identical across window sizes** for the fp32 codec — the
``window=32`` loss curve is the ``window=1`` loss curve, point for point
(pinned by ``tests/test_telemetry.py``).  For *eval* metrics (which need
a host-side predict over the test splits) the engine offers
``RunConfig.eval_align``: windows are split at ``eval_every`` fold
boundaries so evals land exactly where a ``window=1`` run would put them
— a dispatch-count trade the caller opts into, never a numerics change.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.prefetch import PreparedTick

Array = np.ndarray


def _to_host(block) -> Array:
    """A (device) tensor block's values as float32 numpy — the one host
    read per dispatch, taken after the run."""
    if hasattr(block, "detach"):
        block = block.detach().cpu().numpy()
    return np.asarray(block, np.float32)


@dataclasses.dataclass(frozen=True)
class TickRecord:
    """One scheduler tick's summary: in-scan slot values + host metadata."""

    t: int  # global iteration after this tick's folds
    sim_time: float
    n_folds: int  # arrivals folded (participation)
    staleness_mean: float
    staleness_max: int
    values: Dict[str, float]  # slot name -> masked cohort mean


class TelemetryLog:
    """Accumulates per-tick telemetry across a run's dispatches.

    ``append`` stores the device block *without reading it* — pulling a
    device array to host would serialize the tick pipeline, so blocks
    stay device-resident until :meth:`finalize` (the engine calls it
    after the dispatch loop; callers handing their own log to
    ``run_strategy`` receive it finalized).
    """

    def __init__(self, slots: Sequence[str] = ()):
        self.slots: Tuple[str, ...] = tuple(slots)
        self.records: List[TickRecord] = []
        self._pending: List[Tuple[Tuple, int, object]] = []

    def append(self, pt: PreparedTick, tel_block) -> None:
        # keep only the host metadata + the (tiny) device block: holding
        # the PreparedTick itself would pin every window's staging-block
        # device buffers (xs/ys/...) until finalize — O(windows) device
        # memory instead of the TickBuilder's O(NSLOTS) rotation
        self._pending.append((pt.ticks_meta, pt.n_ticks, tel_block))

    def finalize(self) -> List[TickRecord]:
        """Materialize pending device blocks into :class:`TickRecord` rows
        (one host read per dispatch, after the run)."""
        for ticks_meta, n_ticks, block in self._pending:
            arr = _to_host(block).reshape(-1, len(self.slots)) \
                if len(self.slots) else np.zeros((n_ticks, 0), np.float32)
            for j, tm in enumerate(ticks_meta):
                vals = {s: float(arr[j, k])
                        for k, s in enumerate(self.slots)}
                self.records.append(TickRecord(
                    t=tm.t_end, sim_time=tm.sim_time, n_folds=tm.n_folds,
                    staleness_mean=(tm.staleness_sum / tm.n_folds
                                    if tm.n_folds else 0.0),
                    staleness_max=tm.staleness_max, values=vals,
                ))
        self._pending.clear()
        return self.records

    # -- extraction ------------------------------------------------------
    def curve(self, slot: str) -> Tuple[Array, Array]:
        """(t, value) arrays for one slot — per-tick resolution regardless
        of the window size the run dispatched at."""
        if slot not in self.slots:
            raise KeyError(
                f"unknown telemetry slot {slot!r}; this run recorded "
                f"{list(self.slots)}")
        self.finalize()
        ts = np.array([r.t for r in self.records], np.int64)
        vs = np.array([r.values[slot] for r in self.records], np.float32)
        return ts, vs

    def loss_curve(self) -> Tuple[Array, Array]:
        """The per-tick train-loss curve (the ``"train_loss"`` slot)."""
        return self.curve("train_loss")

    def summary(self) -> Dict[str, float]:
        """Run-level reductions for the engine's ``stats`` dict."""
        self.finalize()
        out: Dict[str, float] = {}
        if not self.records:
            return out
        folds = sum(r.n_folds for r in self.records)
        out["participation_mean"] = folds / len(self.records)
        for s in self.slots:
            # fold-weighted mean over ticks + the final tick's value
            tot = sum(r.values[s] * r.n_folds for r in self.records)
            out[f"{s}_mean"] = tot / max(folds, 1)
            out[f"{s}_final"] = self.records[-1].values[s]
        return out


def eval_cut_positions(fold_counts: Sequence[int], t_start: int,
                       eval_every: int) -> List[int]:
    """Indices *after which* a window's tick list must be split so eval
    points land exactly where a ``window=1`` run would put them.

    ``window=1`` evaluates after the first tick whose fold count crosses
    a multiple of ``eval_every``; splitting the fused window at those
    ticks reproduces that cadence without changing any tick's shape
    bucket (so the split is bitwise-free for the fp32 codec).
    """
    cuts: List[int] = []
    next_cut = (t_start // eval_every + 1) * eval_every
    run_t = t_start
    for j, n in enumerate(fold_counts):
        run_t += n
        if run_t >= next_cut:
            if j + 1 < len(fold_counts):
                cuts.append(j + 1)
            while next_cut <= run_t:
                next_cut += eval_every
    return cuts


def split_at_evals(ticks: List[List], t_start: int, eval_every: int,
                   count=len) -> List[List[List]]:
    """Split a window's tick list into eval-aligned segments.

    ``count`` maps one tick to the folds it will charge (the engine
    passes its trainable-arrival counter).  Segment boundaries become
    dispatch boundaries, which is where the engine's consuming loop
    checks the eval cadence.
    """
    cuts = eval_cut_positions([count(tk) for tk in ticks], t_start,
                              eval_every)
    segs: List[List[List]] = []
    prev = 0
    for c in cuts + [len(ticks)]:
        if c > prev:
            segs.append(ticks[prev:c])
        prev = c
    return segs
