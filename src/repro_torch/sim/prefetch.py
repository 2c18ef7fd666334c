"""Host-side tick preparation: staging buffers + double-buffered prefetch.

The cohort engine's host work per tick — drawing every arriving client's
minibatches, padding them to the tick's shape bucket, and transferring the
stacked arrays to device — used to happen inline between two device
dispatches, so the accelerator idled while Python built batches.  This
module makes that work overlappable and allocation-free:

* :class:`TickBuilder` owns **pre-allocated staging buffers per shape
  bucket** (rotated over a small number of slots so a buffer is never
  rewritten while its device transfer may still be in flight) and fills
  them in place via ``OnlineStream.batch_into`` — no per-tick ``np.stack``
  / ``np.concatenate`` churn.  Buckets are powers of two: ``bucket_size``
  rounds *both* the cohort cap and the arrival count to the power-of-two
  grid, keeping the engine's compile cache at O(log K) entries even when
  the cap itself is not a power of two.
* :class:`TickPrefetcher` runs a tick-producing iterator on a side thread
  with a bounded queue (depth 1 == double buffering): tick ``i+1``'s
  batches are drawn and transferred while tick ``i`` executes on device.
  All scheduler and stream rng state is touched only by the producer
  thread, and the producer uses ``AsyncScheduler.peek_tick``/``commit`` so
  speculation never perturbs the event stream — prefetch on/off replays
  bit-identical trajectories.
* ``TickBuilder.build_window`` stacks a whole *window* of ticks into one
  ``[T_w, bucket, ...]`` staging block for the engine's window dispatch
  (one transfer per window; the engine walks the window's ticks), built
  speculatively via ``AsyncScheduler.peek_window``/``commit`` — the same
  double-buffer rotation and determinism contract, T−1 fewer transfers
  per window.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.scheduler import Arrival

Array = np.ndarray


class StalenessMeter:
    """Per-arrival staleness accounting: global iterations since each
    client's previous fold (a first arrival counts from iteration 0 —
    the FedAsync version-vector convention).  One implementation shared
    by the engine's :class:`TickBuilder` and the reference oracles, so
    their stats stay comparable by construction."""

    def __init__(self):
        self.sum = 0.0
        self.max = 0
        self.n = 0
        self._last: Dict[int, int] = {}

    def observe(self, cid: int, t: int) -> int:
        """Record one arrival; returns its staleness (telemetry hook)."""
        stal = t - self._last.get(cid, 0)
        self._last[cid] = t
        self.sum += stal
        self.max = max(self.max, stal)
        self.n += 1
        return stal

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def state_dict(self) -> dict:
        """JSON-able snapshot (crash-resume hook; dict keys stringified
        because JSON objects key on strings)."""
        return {"sum": self.sum, "max": self.max, "n": self.n,
                "last": {str(k): v for k, v in self._last.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.sum = float(state["sum"])
        self.max = int(state["max"])
        self.n = int(state["n"])
        self._last = {int(k): int(v) for k, v in state["last"].items()}


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def bucket_size(n_real: int, pad: int) -> int:
    """Power-of-two shape bucket for a tick of ``n_real`` arrivals.

    Both operands are rounded to the power-of-two grid: capping at a
    non-power-of-two ``pad`` (e.g. a FedAvg participant count of 6) would
    otherwise mint one extra compiled shape per distinct cap value.  The
    returned bucket may *exceed* ``pad`` — the surplus slots are masked
    padding, which costs a little compute but no extra compilation.
    """
    return min(_pow2(max(pad, 1)), _pow2(max(n_real, 1)))


@dataclasses.dataclass(frozen=True)
class TickMeta:
    """Host-side per-tick bookkeeping recorded by the TickBuilder in fold
    order: the telemetry layer joins these rows with the in-scan metric
    block the dispatch returns (``repro_torch.sim.telemetry``), so per-tick
    participation/staleness summaries cost no device work at all."""

    t_end: int  # global iteration after this tick's folds
    sim_time: float  # arrival instant of the tick's last fold
    n_folds: int  # arrivals folded (participation)
    staleness_sum: int  # sum over the tick's arrivals
    staleness_max: int


@dataclasses.dataclass
class PreparedTick:
    """One tick's (or one fused window's) device-resident inputs plus its
    bookkeeping metadata.

    ``arrays`` is the engine tick signature tail
    ``(idx, lidx, xs, ys, delays, n_vis, t_arr, mask, fresh, dup,
    corrupt, stal)`` — ``lidx`` is the storage-row column (== ``idx``
    under device residency, the pool-block row under host residency; see
    ``repro_torch.sim.compile.tick_body``), and the last four are the chaos
    columns (crash-rejoin flag, duplicate-delivery flag, corruption wire
    code, per-arrival staleness) — already transferred (and, on a mesh,
    sharded) by the TickBuilder.  For a megastep window every array carries
    an extra leading ``[T_w]`` axis (one slice per fused tick) and
    ``n_ticks`` counts the real (non-padding) ticks.  ``ticks_meta``
    carries one :class:`TickMeta` per real tick.  ``host_snapshot``,
    when set, is a full-run host-state snapshot captured by the producer
    *before* this block's speculative peek (the crash-resume checkpoint
    hook): the consumer persists it before dispatching the block, so a
    resumed run replays from exactly this boundary.

    Under host state residency the TickBuilder additionally stages the
    window's pool gather: ``block`` is the host-side cohort state block
    (leaves ``[R, ...]``, gathered speculatively on the producer
    thread), ``block_cids`` the pool row per block row (padding rows
    repeat the first member), ``block_rows`` the number of real member
    rows (the scatter-back set; row ``block_rows`` is the window's
    scratch row), and ``gather_seq`` the pool write-sequence the gather
    saw — the consumer passes it to ``HostStatePool.patch`` to re-copy
    rows updated by megasteps that were still in flight at gather time.
    """

    arrivals: List[Arrival]  # trainable arrivals, in fold order
    t_start: int  # global iteration at tick start
    t_end: int  # global iteration after the tick's folds
    sim_time: float  # simulated time of the last arrival
    arrays: Tuple  # (idx, lidx, xs, ys, delays, n_vis, t_arr, mask,
    #                fresh, dup, corrupt, stal)
    n_ticks: int = 1  # real scheduler ticks fused into this dispatch
    ticks_meta: Tuple[TickMeta, ...] = ()
    host_snapshot: Optional[dict] = None  # pre-peek run state (checkpoint)
    block: Optional[object] = None  # host-residency staged state block
    block_cids: Optional[Array] = None  # pool row of each block row
    block_rows: int = 0  # real member rows (scatter-back count)
    gather_seq: int = 0  # pool write-sequence at gather time


class TickBuilder:
    """Builds padded tick inputs into per-bucket staging buffers.

    ``transfer(name, np_array)`` moves one staging array to device (the
    engine binds it to a copying ``torch.tensor(..., device=...)``).  The
    small per-slot metadata arrays are allocated once per bucket; the
    ``xs``/``ys`` data buffers once per (bucket, batch shape).  Buffers
    rotate over ``NSLOTS`` slots so the arrays handed to the device for
    tick ``i`` are never overwritten while building tick ``i+1`` — safe
    even if a future backend transfers zero-copy.

    Padded slots keep whatever rows the previous occupant of the bucket
    left behind: their uploads are masked out of the fold and their
    write-back targets the scratch row, so only finiteness matters (stale
    real batches are as finite as the zero rows the engine used to
    materialize each tick).
    """

    NSLOTS = 3

    def __init__(self, *, by_id: Dict[int, object], batch_size: int,
                 local_epochs: int, scratch: int, pad: int, pooled: bool,
                 transfer: Callable[[str, Array], object],
                 window_transfer: Optional[Callable[[str, Array],
                                                    object]] = None,
                 state_pool=None):
        self.by_id = by_id
        self.B = batch_size
        self.E = local_epochs
        self.scratch = scratch
        self.pad = pad
        self.pooled = pooled
        # host state residency: gather each window's member rows from the
        # HostStatePool here, on the producer thread, so the host→device
        # state traffic overlaps the previous megastep like the batches do
        self.state_pool = state_pool
        self.transfer = transfer
        # window blocks carry a leading [T_w] time axis: on a mesh their
        # client axis is axis 1, so they need their own sharding rule
        self.window_transfer = window_transfer or transfer
        self.host_build_s = 0.0  # accumulated host batch-build + transfer time
        # tracked here because the TickBuilder sees every arrival in fold
        # order — on the producer thread when prefetching — so the
        # engine loop stays untouched
        self.staleness = StalenessMeter()
        self._meta: Dict[Tuple, Dict[str, Array]] = {}
        self._data: Dict[Tuple, Tuple[Array, Array]] = {}
        self._slot = 0

    def _meta_slot(self, shape: Tuple[int, ...], slot: int) -> Dict[str, Array]:
        key = (shape, slot)
        buf = self._meta.get(key)
        if buf is None:
            buf = {
                "idx": np.empty(shape, np.int32),
                "lidx": np.empty(shape, np.int32),
                "delays": np.empty(shape, np.float32),
                "n_vis": np.empty(shape, np.float32),
                "t_arr": np.empty(shape, np.float32),
                "mask": np.empty(shape, bool),
                # chaos columns (all-zero for fault-free runs; the tick
                # traces no ops on them unless faults/guards are on)
                "fresh": np.empty(shape, bool),
                "dup": np.empty(shape, bool),
                "corrupt": np.empty(shape, np.int32),
                "stal": np.empty(shape, np.float32),
            }
            self._meta[key] = buf
        return buf

    def _data_slot(self, shape: Tuple[int, ...], slot: int, tx: Tuple,
                   ty: Tuple) -> Tuple[Array, Array]:
        (x_shape, x_dtype), (y_shape, y_dtype) = tx, ty
        key = (shape, slot, x_shape, y_shape)
        buf = self._data.get(key)
        if buf is None:
            buf = (np.zeros(shape + x_shape, x_dtype),
                   np.zeros(shape + y_shape, y_dtype))
            self._data[key] = buf
        return buf

    def _slot_template(self, pooled_batch) -> Tuple[Tuple, Tuple]:
        """Per-slot (x, y) (shape, dtype) pairs, computed once."""
        if pooled_batch is not None:
            px, py = pooled_batch
            return (px.shape, px.dtype), (py.shape, py.dtype)
        if not hasattr(self, "_tmpl"):
            c = next(iter(self.by_id.values()))
            x_row, y_row = c.stream.x, c.stream.y
            self._tmpl = (
                ((self.E, self.B) + x_row.shape[1:], x_row.dtype),
                ((self.E, self.B) + y_row.shape[1:], y_row.dtype),
            )
        return self._tmpl

    def build(self, arrivals: Sequence[Arrival], times: Sequence[int],
              sim_time: float, pooled_batch=None, *,
              advance: bool = True) -> PreparedTick:
        """Fill one tick's staging buffers and transfer them to device.

        ``times`` gives the global-iteration stamp of each arrival (the
        fold order t, t+1, ... for async schedules; a constant round index
        for sync ones — those pass ``advance=False`` so the tick's
        telemetry stamp is the round itself, not round+1).  Minibatches
        are drawn in arrival order, exactly as the inline loop did — the
        per-client stream rngs advance identically, which the prefetch
        determinism tests pin down.
        """
        t0 = time.perf_counter()
        n_real = len(arrivals)
        P = 1 if self.pooled else bucket_size(n_real, self.pad)
        slot = self._slot
        self._slot = (slot + 1) % self.NSLOTS
        meta = self._meta_slot((P,), slot)
        meta["idx"].fill(self.scratch)
        meta["lidx"].fill(self.scratch)
        meta["delays"].fill(0.0)
        meta["n_vis"].fill(0.0)
        meta["t_arr"].fill(0.0)
        meta["mask"].fill(False)
        meta["fresh"].fill(False)
        meta["dup"].fill(False)
        meta["corrupt"].fill(0)
        meta["stal"].fill(0.0)
        tx, ty = self._slot_template(pooled_batch)
        xs, ys = self._data_slot((P,), slot, tx, ty)
        stal_sum, stal_max = 0, 0
        for i, a in enumerate(arrivals):
            t_i = times[i]
            stal = self.staleness.observe(a.cid, t_i)
            stal_sum += stal
            stal_max = max(stal_max, stal)
            meta["idx"][i] = 0 if self.pooled else a.cid
            meta["lidx"][i] = meta["idx"][i]  # device residency: same row
            meta["delays"][i] = a.delay
            meta["t_arr"][i] = t_i
            meta["mask"][i] = True
            meta["fresh"][i] = getattr(a, "fresh", False)
            meta["dup"][i] = getattr(a, "dup", False)
            meta["corrupt"][i] = getattr(a, "corrupt", 0)
            meta["stal"][i] = stal
            if pooled_batch is not None:
                xs[i], ys[i] = pooled_batch
            else:
                c = self.by_id[a.cid]
                meta["n_vis"][i] = c.stream.visible(t_i)
                for e in range(self.E):
                    c.stream.batch_into(t_i, xs[i, e], ys[i, e])
        arrays = (
            self.transfer("idx", meta["idx"]),
            self.transfer("lidx", meta["lidx"]),
            self.transfer("xs", xs),
            self.transfer("ys", ys),
            self.transfer("delays", meta["delays"]),
            self.transfer("n_vis", meta["n_vis"]),
            self.transfer("t_arr", meta["t_arr"]),
            self.transfer("mask", meta["mask"]),
            self.transfer("fresh", meta["fresh"]),
            self.transfer("dup", meta["dup"]),
            self.transfer("corrupt", meta["corrupt"]),
            self.transfer("stal", meta["stal"]),
        )
        self.host_build_s += time.perf_counter() - t0
        t_end = (times[-1] + (1 if advance else 0)) if len(times) else 0
        return PreparedTick(
            arrivals=list(arrivals),
            t_start=times[0] if len(times) else 0,
            # async fold order stamps t, t+1, ...; sync rounds stamp a
            # constant t (advance=False) and ignore t_end
            t_end=t_end,
            sim_time=sim_time, arrays=arrays,
            ticks_meta=(TickMeta(t_end=t_end, sim_time=sim_time,
                                 n_folds=n_real, staleness_sum=stal_sum,
                                 staleness_max=stal_max),),
        )

    def build_window(self, ticks: Sequence[Sequence[Arrival]], *,
                     t_start: int, window: int,
                     sim_time: float) -> PreparedTick:
        """Stack a whole window of ticks into one ``[T_w, bucket, ...]``
        staging block and transfer it in one shot.

        ``ticks`` are consecutive scheduler ticks (trainable arrivals in
        fold order); global-iteration stamps run ``t_start, t_start+1, ...``
        across the flattened window, and every client's minibatches are
        drawn in that same order — exactly the draws the per-tick path
        makes, so window size never perturbs the stream rngs.  Both window
        dims ride the power-of-two grid: ``T_w`` rounds the tick count to
        the bucket of ``window`` and the cohort axis rounds the *largest*
        tick to the bucket of ``pad``, so the compiled megastep cache
        stays O(log window · log K).  Padding ticks are fully masked
        (scratch-row writes, no server folds): they cost a little compute
        on the drained tail but never a fresh compilation.
        """
        t0 = time.perf_counter()
        Tw = bucket_size(len(ticks), window)
        P = bucket_size(max(len(tk) for tk in ticks), self.pad)
        # host residency: assign each distinct client of the window one
        # pool-block row, in first-appearance order (deterministic — the
        # same arrival stream maps to the same rows at any prefetch
        # setting), and speculatively gather those rows from the pool.
        # A client arriving twice in the window shares one row, so tick
        # j+1's gather sees tick j's scatter through the scan carry,
        # exactly as the device-resident [K+1] stack does.
        rowof = None
        block = block_cids = None
        block_rows = gather_seq = 0
        if self.state_pool is not None:
            rowof = {}
            for tk in ticks:
                for a in tk:
                    if a.cid not in rowof:
                        rowof[a.cid] = len(rowof)
            block_rows = len(rowof)
            # bucket the block's row axis (+1 scratch row at index
            # block_rows) so the megastep compile cache stays O(log K);
            # rows past the scratch row are never gathered by any lidx —
            # fill them (and the scratch row) with the first member's
            # encoded row, which is as finite as any real row
            R = _pow2(block_rows + 1)
            block_cids = np.fromiter(rowof, np.int64, len(rowof))
            block_cids = np.concatenate([
                block_cids,
                np.full(R - block_rows, block_cids[0], np.int64)])
            block, gather_seq = self.state_pool.gather(block_cids)
        scratch_row = self.scratch if rowof is None else block_rows
        slot = self._slot
        self._slot = (slot + 1) % self.NSLOTS
        meta = self._meta_slot((Tw, P), slot)
        meta["idx"].fill(self.scratch)
        meta["lidx"].fill(scratch_row)
        meta["delays"].fill(0.0)
        meta["n_vis"].fill(0.0)
        meta["t_arr"].fill(0.0)
        meta["mask"].fill(False)
        meta["fresh"].fill(False)
        meta["dup"].fill(False)
        meta["corrupt"].fill(0)
        meta["stal"].fill(0.0)
        tx, ty = self._slot_template(None)
        xs, ys = self._data_slot((Tw, P), slot, tx, ty)
        t_run = t_start
        flat: List[Arrival] = []
        ticks_meta: List[TickMeta] = []
        for j, tk in enumerate(ticks):
            stal_sum, stal_max = 0, 0
            for i, a in enumerate(tk):
                stal = self.staleness.observe(a.cid, t_run)
                stal_sum += stal
                stal_max = max(stal_max, stal)
                meta["idx"][j, i] = a.cid
                meta["lidx"][j, i] = (a.cid if rowof is None
                                      else rowof[a.cid])
                meta["delays"][j, i] = a.delay
                meta["t_arr"][j, i] = t_run
                meta["mask"][j, i] = True
                meta["fresh"][j, i] = getattr(a, "fresh", False)
                meta["dup"][j, i] = getattr(a, "dup", False)
                meta["corrupt"][j, i] = getattr(a, "corrupt", 0)
                meta["stal"][j, i] = stal
                c = self.by_id[a.cid]
                meta["n_vis"][j, i] = c.stream.visible(t_run)
                for e in range(self.E):
                    c.stream.batch_into(t_run, xs[j, i, e], ys[j, i, e])
                t_run += 1
                flat.append(a)
            ticks_meta.append(TickMeta(
                t_end=t_run, sim_time=tk[-1].time, n_folds=len(tk),
                staleness_sum=stal_sum, staleness_max=stal_max))
        arrays = (
            self.window_transfer("idx", meta["idx"]),
            self.window_transfer("lidx", meta["lidx"]),
            self.window_transfer("xs", xs),
            self.window_transfer("ys", ys),
            self.window_transfer("delays", meta["delays"]),
            self.window_transfer("n_vis", meta["n_vis"]),
            self.window_transfer("t_arr", meta["t_arr"]),
            self.window_transfer("mask", meta["mask"]),
            self.window_transfer("fresh", meta["fresh"]),
            self.window_transfer("dup", meta["dup"]),
            self.window_transfer("corrupt", meta["corrupt"]),
            self.window_transfer("stal", meta["stal"]),
        )
        self.host_build_s += time.perf_counter() - t0
        return PreparedTick(
            arrivals=flat, t_start=t_start, t_end=t_run,
            sim_time=sim_time, arrays=arrays, n_ticks=len(ticks),
            ticks_meta=tuple(ticks_meta),
            block=block, block_cids=block_cids, block_rows=block_rows,
            gather_seq=gather_seq,
        )


class TickPrefetcher:
    """Runs a tick iterator on a side thread with a bounded queue.

    ``depth=1`` is classic double buffering: at most one built-but-unconsumed
    tick, plus the one the worker is currently building.  Exceptions raised
    by the producer surface on the consuming thread at the corresponding
    ``__next__``.  ``close()`` stops the worker promptly (used on early
    exit) — because the producer speculates via ``peek_tick``/``commit``,
    an abandoned in-flight tick leaves the scheduler's committed event
    stream untouched.
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator[PreparedTick], depth: int = 1):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(it,), name="tick-prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator[PreparedTick]) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> PreparedTick:
        item = self._q.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
