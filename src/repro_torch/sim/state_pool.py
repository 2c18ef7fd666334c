"""Host-resident out-of-core client-state pool.

The port's copy of ``repro.sim.state_pool``.  With
``RunConfig.state_residency="host"`` the full codec-encoded ``[K, ...]``
client state lives here, in plain (optionally sharded) numpy arrays,
and only the rows a window touches are gathered host -> device per
window and scattered back after it: device memory for client state
follows the active cohort, not the fleet size K.

Layout: one 2-D array per state leaf, ``[K, n_elem]`` (rows flattened,
so gathers are contiguous row copies), in the codec's storage dtype.
The int4 codec's leaves (int8 codes in ``[-7, 7]``) are stored
nibble-packed, two codes per byte, and unpacked to int8 on gather.
numpy has no bf16 dtype, so bf16 leaves are held as their 16-bit
patterns (``np.int16``) and reinterpreted at the transfer
(:func:`leaf_to_host` / :func:`leaf_to_device`).

Concurrency contract: gathers run on the ``TickPrefetcher`` producer
thread (overlapping the previous window) while scatters run on the
consumer thread.  A gather is a **pure read** staged into a rotating
pre-allocated buffer; each row write bumps a per-row write-sequence
*before* touching data, so the consumer's pre-dispatch :meth:`patch`
re-copies exactly the rows written after the speculative gather.
Gather / scatter counters snapshot and roll back like the scheduler's
fault counters.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import (tree_flatten, tree_leaves,
                                       tree_unflatten)

# Staging slots for gathered blocks: the prefetch pipeline holds at most
# one window in flight, one queued, one being built — +1 slack.
NSTAGE = 4


def leaf_to_host(t: torch.Tensor) -> np.ndarray:
    """A state leaf as numpy, for the pool: bf16 as its int16 bit
    patterns (numpy has no bf16), every other dtype as it is."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def leaf_to_device(a: np.ndarray, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """A pool leaf on ``device`` as ``dtype``, in fresh memory (never an
    alias of ``a``: the pool rotates its staging buffers)."""
    t = torch.from_numpy(a).to(device, copy=True)
    return t.view(dtype) if dtype == torch.bfloat16 else t


def pack_int4(codes: np.ndarray) -> np.ndarray:
    """Nibble-pack int8 codes in ``[-8, 7]``: ``[..., n]`` → uint8
    ``[..., ceil(n/2)]`` (two's-complement low nibble first)."""
    n = codes.shape[-1]
    if n % 2:
        codes = np.concatenate(
            [codes, np.zeros(codes.shape[:-1] + (1,), np.int8)], axis=-1)
    u = codes.astype(np.uint8) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_int4`: uint8 ``[..., ceil(n/2)]`` → int8
    ``[..., n]`` with sign extension."""
    lo = (packed & 0xF).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    out = np.empty(packed.shape[:-1] + (2 * packed.shape[-1],), np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    # sign-extend the 4-bit two's-complement nibbles
    out = ((out ^ 8) - 8).astype(np.int8)
    return out[..., :n]


class HostStatePool:
    """The host-side ``[K, ...]`` encoded client-state store.

    ``row_template`` is a single encoded state row (a tree of numpy
    leaves *without* the leading client axis) fixing structure, shapes,
    and storage dtypes.  ``packed=True`` nibble-packs int8 leaves (the
    int4 codec); ``shards > 1`` splits rows across contiguous per-leaf
    sub-arrays (the gather / scatter API is shard-transparent).
    """

    def __init__(self, row_template, n_rows: int, *, packed: bool = False,
                 shards: int = 1):
        if n_rows < 1:
            raise ValueError(f"HostStatePool needs n_rows >= 1, got {n_rows}")
        if shards < 1 or shards > n_rows:
            raise ValueError(
                f"shards must be in [1, n_rows={n_rows}], got {shards}")
        leaves, treedef = tree_flatten(row_template)
        self.n_rows = int(n_rows)
        self.packed = bool(packed)
        self.shards = int(shards)
        self._treedef = treedef
        self._shapes = [tuple(np.shape(x)) for x in leaves]
        self._dtypes = [np.dtype(np.asarray(x).dtype) for x in leaves]
        self._elems = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self._is_packed = [self.packed and dt == np.int8
                           for dt in self._dtypes]
        # contiguous row ranges per shard: shard s owns [bounds[s],
        # bounds[s+1])
        self._bounds = np.linspace(0, n_rows, shards + 1).astype(np.int64)
        self._data: List[List[np.ndarray]] = []
        for ne, dt, pk in zip(self._elems, self._dtypes, self._is_packed):
            width = (ne + 1) // 2 if pk else ne
            sdt = np.uint8 if pk else dt
            self._data.append([
                np.zeros((int(self._bounds[s + 1] - self._bounds[s]), width),
                         sdt)
                for s in range(shards)])
        # per-row write sequence for dirty-row patching: bumped BEFORE
        # the row data is written (see the module concurrency contract)
        self._last_write = np.zeros(n_rows, np.int64)
        self._seq = 0
        # rotating gather staging buffers, keyed by block row count
        self._stage: Dict[int, List] = {}
        self._stage_cursor: Dict[int, int] = {}
        # committed-stats counters (snapshot / rollback like the
        # scheduler's fault counters)
        self.gathered_rows = 0
        self.scattered_rows = 0
        self.gather_s = 0.0
        self.scatter_s = 0.0

    # -- memory accounting --------------------------------------------

    @property
    def nbytes(self) -> int:
        """Bytes held by the state arrays themselves (packed leaves count
        their packed size; excludes the int64 write-sequence column)."""
        return sum(int(a.nbytes) for per in self._data for a in per)

    # -- counters (speculation rollback contract) ---------------------

    def counters(self) -> dict:
        return dict(gathered_rows=self.gathered_rows,
                    scattered_rows=self.scattered_rows,
                    gather_s=self.gather_s, scatter_s=self.scatter_s)

    def restore_counters(self, snap: dict) -> None:
        self.gathered_rows = snap["gathered_rows"]
        self.scattered_rows = snap["scattered_rows"]
        self.gather_s = snap["gather_s"]
        self.scatter_s = snap["scatter_s"]

    # -- internal row addressing --------------------------------------

    def _locate(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(shard_id, local_row) for each global row index."""
        sid = np.searchsorted(self._bounds, rows, side="right") - 1
        return sid, rows - self._bounds[sid]

    def _read_rows(self, li: int, rows: np.ndarray) -> np.ndarray:
        data = self._data[li]
        if self.shards == 1:
            return data[0][rows]
        sid, loc = self._locate(rows)
        out = np.empty((len(rows), data[0].shape[1]), data[0].dtype)
        for s in np.unique(sid):
            sel = sid == s
            out[sel] = data[s][loc[sel]]
        return out

    def _write_rows(self, li: int, rows: np.ndarray, vals: np.ndarray
                    ) -> None:
        data = self._data[li]
        if self.shards == 1:
            data[0][rows] = vals
            return
        sid, loc = self._locate(rows)
        for s in np.unique(sid):
            sel = sid == s
            data[s][loc[sel]] = vals[sel]

    # -- bulk init / checkpoint interface -----------------------------

    def write_block(self, start: int, block) -> None:
        """Store ``block`` (a tree of numpy leaves ``[C, ...]``) at rows
        ``[start, start + C)`` — the chunked-init path (device init →
        encode → pool, one chunk's device footprint at a time)."""
        leaves = tree_leaves(block)
        rows = np.arange(start, start + np.shape(leaves[0])[0])
        self._seq += 1
        self._last_write[rows] = self._seq
        for li, leaf in enumerate(leaves):
            flat = np.asarray(leaf).reshape(len(rows), -1)
            if self._is_packed[li]:
                flat = pack_int4(flat)
            self._write_rows(li, rows, flat)

    def flat_items(self):
        """[(key, array)] views of the raw storage, for streaming
        checkpoint writes — no copy is made here."""
        out = []
        for li in range(len(self._data)):
            for s, arr in enumerate(self._data[li]):
                out.append((f"leaf{li:04d}_shard{s:04d}", arr))
        return out

    def load_flat(self, arrays: Dict[str, np.ndarray]) -> None:
        """Restore storage written from :meth:`flat_items` (checkpoint
        resume).  Shapes / dtypes must match this pool's construction."""
        for key, arr in self.flat_items():
            if key not in arrays:
                raise ValueError(
                    f"host-pool snapshot missing array {key!r} — was the "
                    "snapshot written with a different fleet size, state "
                    "dtype, or shard count?")
            src = arrays[key]
            if src.shape != arr.shape or src.dtype != arr.dtype:
                raise ValueError(
                    f"host-pool snapshot array {key!r} is "
                    f"{src.shape}/{src.dtype}, expected "
                    f"{arr.shape}/{arr.dtype}")
            arr[...] = src

    # -- the hot path: per-window gather / patch / scatter ------------

    def gather(self, rows: np.ndarray) -> Tuple[object, int]:
        """(block, gather_seq): decode-ready staged copy of ``rows``
        (leaves ``[R, *shape]``, R = len(rows); int4 leaves arrive
        unpacked to int8).  Pure read — safe to run speculatively on the
        producer thread; pair with :meth:`patch` before dispatch."""
        t0 = time.perf_counter()
        rows = np.asarray(rows, np.int64)
        R = len(rows)
        seq = self._seq
        block = self._stage_block(R)
        for li, out in enumerate(tree_leaves(block)):
            flat = self._read_rows(li, rows)
            if self._is_packed[li]:
                flat = unpack_int4(flat, self._elems[li])
            out[...] = flat.reshape(out.shape)
        self.gathered_rows += R
        self.gather_s += time.perf_counter() - t0
        return block, seq

    def patch(self, block, rows: np.ndarray, gather_seq: int) -> int:
        """Re-copy the rows of ``block`` written since ``gather_seq``
        (consumer side, after all prior windows scattered back).
        Returns the number of patched rows."""
        t0 = time.perf_counter()
        rows = np.asarray(rows, np.int64)
        dirty = np.nonzero(self._last_write[rows] > gather_seq)[0]
        if len(dirty):
            drows = rows[dirty]
            for li, out in enumerate(tree_leaves(block)):
                flat = self._read_rows(li, drows)
                if self._is_packed[li]:
                    flat = unpack_int4(flat, self._elems[li])
                out[dirty] = flat.reshape((len(dirty),) + out.shape[1:])
        self.gather_s += time.perf_counter() - t0
        return int(len(dirty))

    def scatter(self, rows: np.ndarray, block) -> None:
        """Write the first ``len(rows)`` rows of ``block`` (a tree of
        numpy leaves ``[R >= len(rows), ...]``: the window's updated
        cohort carry) back into the pool."""
        t0 = time.perf_counter()
        rows = np.asarray(rows, np.int64)
        self._seq += 1
        self._last_write[rows] = self._seq  # before data: see module doc
        for li, leaf in enumerate(tree_leaves(block)):
            flat = np.asarray(leaf[:len(rows)]).reshape(len(rows), -1)
            if self._is_packed[li]:
                flat = pack_int4(flat)
            self._write_rows(li, rows, flat)
        self.scattered_rows += len(rows)
        self.scatter_s += time.perf_counter() - t0

    def _stage_block(self, R: int):
        """A rotating pre-allocated staging block with leaves
        ``[R, *shape]`` in storage (unpacked) dtypes."""
        if R not in self._stage:
            self._stage[R] = [
                tree_unflatten(self._treedef, [
                    np.zeros((R,) + shp, dt)
                    for shp, dt in zip(self._shapes, self._dtypes)])
                for _ in range(NSTAGE)]
            self._stage_cursor[R] = 0
        cur = self._stage_cursor[R]
        self._stage_cursor[R] = (cur + 1) % NSTAGE
        return self._stage[R][cur]
