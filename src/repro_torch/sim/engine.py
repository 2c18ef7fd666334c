"""Cohort engine of the port: ``run_strategy``.

Counterpart of ``repro.sim.engine`` for the part the port covers: the
asynchronous, synchronous and sweep schedules, the sequential and associative
server folds, the stacked client state stored in fp32, bf16, fp16, int8
or int4 (``state_dtype``) on the device or, for the async schedule, in a
host pool (``state_residency="host"``, ``repro_torch.sim.state_pool``),
the lossy upload codecs (``upload_codec``) and the chaos layer (faults
from each client's ``FaultSpec``: crash-restart, wire corruption,
duplicate delivery; the server's admission guards ``max_staleness`` /
``max_delta_norm``), crash-resume snapshots of the async schedule
(``checkpoint_path`` / ``resume_from``, ``repro_torch.checkpoint``), one
device.
The host layer — schedulers, streams, staging buffers, prefetch thread,
telemetry log — is the JAX package's, copied unchanged, so both engines
replay the same arrival stream draw for draw; the device side is plain
PyTorch plus the hand-written CUDA kernels (the feature pass and the
fold's linear recurrence).

The async engine drains the scheduler in **ticks** (maximal runs of
pending arrivals with pairwise-distinct clients) grouped into **windows**
of ``RunConfig.window`` ticks: the producer stages a whole window in one
block and transfers it once; the consumer runs the window's ticks in
order (``repro_torch.sim.compile``), each at the shape bucket it would
ride alone, so window size and prefetch never change a bit of the
trajectory.  The sync engine runs one tick per round (FedAvg/FedProx);
the sweep engine one tick per round over every client (Local-S) or over
one pooled member (Global).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``): with no card present ``run_strategy`` raises instead
of falling back.  A knob outside the port (a mesh) raises ``ValueError``
naming the knob.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.common.device import resolve_device
from repro_torch.common.dtypes import (resolve_state_dtype,
                                       resolve_state_storage)
from repro_torch.common.pytree import (tree_leaves, tree_map, tree_stack,
                                       tree_unflatten)
from repro_torch.models.convert import params_from_numpy
from repro_torch.sim import compile as compile_lib
from repro_torch.sim.evaluation import Evaluator
from repro_torch.sim.prefetch import TickBuilder, TickPrefetcher, bucket_size
from repro_torch.sim.profiles import SimClient
from repro_torch.sim.scheduler import (AsyncScheduler, SweepScheduler,
                                       SyncScheduler)
from repro_torch.sim.state_pool import (HostStatePool, leaf_to_device,
                                        leaf_to_host)
from repro_torch.sim.streaming import OnlineStream
from repro_torch.sim.telemetry import TelemetryLog, split_at_evals
from repro_torch.sim.traces import utilization as availability_utilization
from repro_torch.sim.workloads import resolve_eval_report


# ---------------------------------------------------------------------------
# Run configuration / history (same fields and defaults as the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunConfig:
    T: int = 200  # global iterations (async) / rounds (sync)
    sim_time_budget: Optional[float] = None  # stop on simulated seconds
    batch_size: int = 32
    local_epochs: int = 2  # E
    eta: float = 0.01  # eta_bar (paper used 0.001 with many more iters)
    lam: float = 1.0  # prox coefficient lambda
    beta: float = 0.001  # decay coefficient
    # the loss selector ("regression" | "classification" | "multilabel");
    # `workload`, when set, names a registered repro_torch.sim.workloads
    # entry whose metric bundle replaces the task-string default
    task: str = "regression"
    workload: Optional[str] = None
    eval_every: int = 10  # 0 disables evaluation entirely
    seed: int = 0
    # ablations / robustness knobs
    feature_learning: bool = True  # ASO-Fed(-F) when False
    dynamic_lr: bool = True  # ASO-Fed(-D) when False
    dropout_frac: float = 0.0  # Fig. 4: fraction permanently dropped
    periodic_dropout: float = 0.0  # Fig. 5: per-iteration skip probability
    # FedAvg / FedProx
    participation: float = 0.2
    prox_mu: float = 0.0
    # FedAsync
    fedasync_alpha: float = 0.6
    fedasync_staleness_exp: float = 0.5
    # FedBuff
    buffer_size: int = 8
    fedbuff_lr: float = 1.0
    # engine
    max_cohort: Optional[int] = None  # cap on clients per tick (None: all)
    # build windows on a side thread (None: on for the card and >=4-core
    # CPU hosts; bit-identical either way)
    prefetch: Optional[bool] = None
    # `window` consecutive async ticks are staged and transferred as one
    # block and run back to back; `eval_align` splits windows at
    # `eval_every` fold boundaries.  `state_dtype`: storage of the stacked
    # client state (None / "fp32" | "bf16" | "fp16" | "int8" | "int4",
    # repro_torch.common.dtypes), quantized codes spanning ±state_qclip
    window: int = 1
    eval_align: bool = False
    state_dtype: Optional[str] = None
    # "device": the [K+1, ...] stack on the run's device; "host": the
    # encoded state in a HostStatePool, gathered and scattered per window
    # (async schedules only); `state_shards` splits the pool's rows
    state_residency: str = "device"
    state_shards: int = 1
    state_qclip: float = 0.5
    # feature pass: None = the device decides (CUDA kernel on the card,
    # plain version on the CPU); True / False must agree with the device
    feature_kernel: Optional[bool] = None
    # server fold: "sequential" (arrival order) | "associative" (one
    # prefix scan per tick, for affine folds) | "auto" (associative on
    # the card when the strategy allows it).  `fold_kernel`: as
    # `feature_kernel`, for the fold's linear-recurrence kernel
    fold_mode: str = "sequential"
    fold_kernel: Optional[bool] = None
    # upload compression of each arrival's wire delta: "identity" |
    # "topk_sparse" | "random_mask" (keep `upload_frac` of each leaf) |
    # "quantized_delta" (`upload_bits`-bit codes)
    upload_codec: str = "identity"
    upload_frac: float = 0.1
    upload_bits: int = 8
    # admission guards (chaos layer): reject (or, under "downweight",
    # rescale) arrivals staler than `max_staleness`, clip wire deltas to
    # the L2 norm `max_delta_norm`; non-finite deltas are always rejected
    max_staleness: Optional[float] = None
    staleness_policy: str = "reject"
    max_delta_norm: Optional[float] = None


@dataclasses.dataclass
class HistoryPoint:
    global_iter: int
    sim_time: float
    wall_time: float
    metrics: Dict[str, float]


# ---------------------------------------------------------------------------
# Strategy protocol
# ---------------------------------------------------------------------------


class Strategy:
    """Algorithm plug-in: local-update and aggregation rules, nothing else.

    Per-member signatures (the cohort axis P is written out):

    * local(state, bcast, xs, ys, delay, n_vis, t_arr)
          -> (state', upload, telemetry)
      over a client-stacked state; ``telemetry`` maps each name in
      :meth:`telemetry_slots` to a (P,) tensor
    * fold(server, upload, idx, n_vis, t_arr) -> (server', received)
      for ONE arrival (``idx``/``n_vis``/``t_arr`` are 0-d tensors)
    * fold_tick(server, uploads, idx, n_vis, t_arr, n_real, reps=None)
          -> (server', received)   (optional: the whole sequential fold
      of a tick, received stacked over the P slots; ``reps`` the (P,)
      int32 fold count of each slot under the chaos layer)
    * merge(state, received) -> state   (post-fold download, stacked)
    * finalize(server) -> server        (sync barrier, e.g. FedAvg average)
    """

    name: str = "base"
    schedule: str = "async"  # "async" | "sync" | "sweep"
    uses_dropout: bool = True
    pooled: bool = False  # Global baseline: one virtual member, pooled data
    eval_per_client: bool = False  # Local baseline: per-client eval params
    # Local baseline: every client starts from its own draw, so
    # run_strategy's init_params is one mapping per client
    per_client_init: bool = False
    # whether build_fold_affine stays exact under duplicate / rejected
    # arrivals (the chaos layer): a declining strategy folds sequentially
    # under faults ("auto") or raises ("associative")
    fold_affine_supports_faults: bool = True

    def telemetry_slots(self, cfg: RunConfig) -> Tuple[str, ...]:
        return ("train_loss",)

    def server_telemetry_slots(self, cfg: RunConfig) -> Tuple[str, ...]:
        """Post-fold server scalars appended to the telemetry row after
        the engine's ``folds_per_tick`` slot (fedbuff's buffer fill)."""
        return ()

    def build_server_telemetry(self, model, cfg: RunConfig):
        """``server -> {slot: scalar}``, required exactly when
        :meth:`server_telemetry_slots` is non-empty."""
        return None

    def init_client(self, model, cfg: RunConfig, w0,
                    client: Optional[SimClient]):
        raise NotImplementedError

    def build_init_client(self, model, cfg: RunConfig):
        """Optional ``(w0, n0 of shape (R,)) -> stacked client state`` of
        R rows; None stacks :meth:`init_client` per client instead."""
        return None

    def init_server(self, model, cfg_model, cfg: RunConfig, w0,
                    clients: Sequence[SimClient],
                    active: Sequence[SimClient]):
        return {}

    def state_codec(self, model, cfg: RunConfig, w0):
        """Optional ``ClientStateCodec`` for the stacked client state
        (``repro_torch.core.algorithms.common``).  None (the default, and
        the answer for ``state_dtype in (None, "fp32")``) stores the fp32
        state directly — the bitwise-replayable path."""
        return None

    def upload_codec_view(self, model, cfg: RunConfig):
        """Optional ``(extract, rebuild)`` pair exposing the strategy's
        wire delta, the model-shaped tree each arrival transmits, for the
        upload codecs and the chaos layer (``repro.sim.engine.Strategy.
        upload_codec_view``), over trees stacked on the cohort axis:

        * ``extract(upload, carry0, bcast) -> delta`` (``carry0``: the
          clients' pre-round state, ``bcast``: the tick's broadcast);
        * ``rebuild(upload, delta, carry0, bcast) -> upload'``: the upload
          with its delta replaced (version stamps pass through).

        None (the default): no compressible upload (the sweep baselines);
        a lossy codec, faults or guards then fail fast."""
        return None

    def build_local(self, model, cfg: RunConfig):
        raise NotImplementedError

    def build_fold(self, model, cfg_model, cfg: RunConfig):
        return None

    def build_fold_tick(self, model, cfg_model, cfg: RunConfig):
        """Optional fused form of the sequential fold: None declines (the
        engine folds one arrival at a time with :meth:`build_fold`), else
        ``(server, uploads, idx, n_vis, t_arr, n_real, reps=None) ->
        (server', received)`` folding the tick's first ``n_real`` slots in
        order, exactly as that loop does, with ``received`` stacked over
        all P slots and each padded slot a copy of the last real one.
        ``reps`` (the chaos layer), a (P,) int32 tensor on the device,
        folds slot ``s`` ``reps[s]`` times (0: skipped, 2: duplicated)."""
        return None

    def build_fold_affine(self, model, cfg_model, cfg: RunConfig):
        """Optional parallel form of :meth:`build_fold` for a fold that
        is affine in the server state: None declines, else ``(carrier,
        coeffs, unfold)`` as in ``repro.sim.engine.Strategy``:

        * ``carrier(server) -> h0``: the affine part of the server state;
        * ``coeffs(server, uploads, idx, n_vis, t_arr, mask) -> (a, b,
          aux)``: ``a`` of shape (P,), ``b`` a tree of ``(P, ...)``
          leaves matching the carrier; masked slots MUST be identities
          (a=1, b=0);
        * ``unfold(server, h, aux, uploads, idx, n_vis, t_arr, mask) ->
          (server', received)`` from the inclusive prefix states ``h``.
        """
        return None

    def build_merge(self, model, cfg: RunConfig):
        return lambda state, received: state

    def build_finalize(self, model, cfg: RunConfig):
        return None

    def server_broadcast(self, server):
        return server

    def eval_params(self, server, stacked_clients=None):
        """Params to evaluate: the central model, or, for a strategy with
        ``eval_per_client`` or ``pooled``, taken from the member rows of
        the stacked client state (the engine passes them only then, so a
        strategy may keep the one-argument form)."""
        return server["w"]

    def pooled_batches(self, clients, t: int, cfg: RunConfig):
        """``(xs, ys)`` of the pooled member's round (Global only)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Host-side batch construction (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def pad_batch(x: np.ndarray, y: np.ndarray, size: int,
              template_x: np.ndarray, template_y: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Force (x, y) to exactly ``size`` rows.

    Short draws are padded by cycling the drawn rows (``np.resize``); an
    *empty* draw (a client whose visible window is empty) yields all-zero
    rows.  ``template_*`` supply the row shape/dtype for the empty case.
    """
    if len(x) == 0:
        return (np.zeros((size,) + template_x.shape[1:], template_x.dtype),
                np.zeros((size,) + template_y.shape[1:], template_y.dtype))
    if len(x) < size:
        x = np.resize(x, (size,) + x.shape[1:])
        y = np.resize(y, (size,) + y.shape[1:])
    return x[:size], y[:size]


def stack_batches(stream: OnlineStream, t: int, batch_size: int,
                  n_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_steps, batch_size, ...) minibatches from one client's stream.

    Consumes the same rng draws as ``OnlineStream.batch_into`` — the
    engine's staging-buffer path and this allocating path are
    interchangeable without perturbing the trajectory.
    """
    xs, ys = [], []
    for _ in range(n_steps):
        x, y = pad_batch(*stream.batch(t, batch_size), batch_size,
                         stream.x, stream.y)
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _check_slice(strategy: Strategy, cfg: RunConfig,
                 clients: Sequence[SimClient], *, mesh,
                 checkpointed: bool) -> None:
    """Raise ``ValueError`` naming the first knob outside this slice, or
    the first malformed one."""
    def refuse(knob: str, value, accepted: str):
        raise ValueError(
            f"{knob}={value!r} is not ported yet (the port runs {accepted})")

    if strategy.schedule not in ("async", "sync", "sweep"):
        refuse("strategy.schedule", strategy.schedule,
               "'async', 'sync' and 'sweep' strategies")
    if checkpointed and strategy.schedule != "async":
        raise ValueError(
            "run checkpointing / resume is supported for async schedules "
            f"only ({strategy.name!r} is {strategy.schedule!r})")
    if mesh is not None:
        refuse("mesh", mesh, "on a single device")
    # the state storage knobs, validated as the JAX engine does
    resolve_state_dtype(cfg.state_dtype)
    if cfg.state_residency not in ("device", "host"):
        raise ValueError(
            f"unknown state_residency {cfg.state_residency!r}; "
            "accepted: 'device' | 'host'")
    if cfg.state_residency == "host" and strategy.schedule != "async":
        raise ValueError(
            "state_residency='host' is supported for async schedules only "
            f"({strategy.name!r} is {strategy.schedule!r}): the host pool "
            "rides the windowed gather/scatter tick path")
    if cfg.state_residency == "host" and (strategy.eval_per_client
                                          or strategy.pooled):
        raise ValueError(
            f"state_residency='host' cannot serve {strategy.name!r}: "
            "per-client / pooled evaluation reads the full stacked state, "
            "which a host-resident pool keeps off-device")
    if cfg.state_shards < 1:
        raise ValueError(
            f"state_shards must be >= 1, got {cfg.state_shards}")
    if cfg.eval_every < 0:
        raise ValueError(
            f"eval_every must be >= 0 (0 disables evaluation), "
            f"got {cfg.eval_every}")
    if cfg.staleness_policy not in ("reject", "downweight"):
        raise ValueError(
            f"unknown staleness_policy {cfg.staleness_policy!r}; "
            "accepted: 'reject' | 'downweight'")


def faults_active(clients: Sequence[SimClient]) -> bool:
    """Whether any client carries an active ``FaultSpec``: the run's
    ticks are then fault-aware (crash-restart, wire corruption, duplicate
    double folds), and the admission guards act with them."""
    return any(c.profile.faults is not None and c.profile.faults.active
               for c in clients)


def _check_chaos(strategy: Strategy, model, cfg: RunConfig,
                 faults_on: bool):
    """The run's ``UploadCodec`` and whether its ticks are chaos ticks,
    after ``repro.sim.engine.run_strategy``'s checks (same messages): a
    lossy codec, faults or guards on a strategy with no wire-delta view,
    and faults on an async strategy that cannot rebuild a crashed row,
    fail before any work is done."""
    # imported here: the strategy modules import Strategy from this
    # module, so a top-level import of repro_torch.core would be circular
    from repro_torch.core.algorithms.common import resolve_upload_codec

    ucodec = resolve_upload_codec(cfg)
    uview = strategy.upload_codec_view(model, cfg)
    if not ucodec.identity and uview is None:
        raise ValueError(
            f"upload_codec={cfg.upload_codec!r} requires a strategy with "
            f"a compressible upload, but {strategy.name!r} provides no "
            "upload_codec_view (the Local/Global sweep baselines upload "
            "nothing)")
    chaos = faults_on or cfg.max_staleness is not None \
        or cfg.max_delta_norm is not None
    if chaos and strategy.schedule != "sweep" and uview is None:
        raise ValueError(
            "fault injection / admission guards act on the strategy's "
            f"wire-delta view, but {strategy.name!r} provides no "
            "upload_codec_view")
    if faults_on and strategy.schedule == "async" \
            and strategy.build_init_client(model, cfg) is None:
        raise ValueError(
            f"fault injection needs {strategy.name!r} to provide "
            "build_init_client: crash-restart rebuilds the crashed "
            "client's state row inside the tick")
    return ucodec, uview


def run_strategy(
    strategy: Strategy,
    model,
    cfg_model,
    clients: Sequence[SimClient],
    cfg: RunConfig,
    *,
    max_cohort: Optional[int] = None,
    trace: Optional[List] = None,
    stats: Optional[Dict] = None,
    telemetry: Optional[TelemetryLog] = None,
    prefetch: Optional[bool] = None,
    window: Optional[int] = None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume_from: Optional[str] = None,
    device=None,
    init_params: Union[Mapping[str, Any], Sequence[Mapping[str, Any]],
                       None] = None,
) -> List[HistoryPoint]:
    """Run one algorithm through the port's cohort engine.

    Same contract as ``repro.sim.engine.run_strategy`` for the slice it
    covers.  ``device`` is the run's device (None: the CUDA card).
    ``init_params`` (a name -> array mapping, e.g. the JAX package's
    ``w0`` as numpy) replaces the seeded draw of the starting weights, so
    a test can start both engines from the same ``w0``; for a strategy
    whose clients start from their own draws (Local-S) it is a sequence
    of K such mappings, one per client in cid order.  ``trace``, when
    a list, receives ``(t, {name: numpy server weight})`` after every
    window; ``stats``, when a dict, is filled with the run's counters and
    per-phase wall times; ``telemetry`` receives one record per tick.

    ``checkpoint_path`` (async schedules only) writes a resumable
    snapshot (``repro_torch.checkpoint.save_run_state``: the stacked
    client state or the host pool, the server state, and the host cursor
    of scheduler, stream rngs and staleness meter) every
    ``checkpoint_every`` iterations (default ``cfg.eval_every``, or
    ``cfg.T`` with evaluation off), in the JAX package's format.
    ``resume_from`` restores one (written by either package) and
    continues: the rest of the arrival stream replays, so the final
    weights equal the uninterrupted run's bit for bit (``history`` and
    ``trace`` cover the windows after the resume only).  ``stats`` then
    carries ``resumed_from_t``; ``ckpt_writes``, ``ckpt_write_s`` (wall
    seconds spent writing) and ``ckpt_bytes`` (the last snapshot's bytes
    on disk) are the port's own counters, not the JAX engine's; none of
    them changes a result.
    """
    entry = time.perf_counter()
    clients = list(clients)
    K = len(clients)
    if [c.cid for c in clients] != list(range(K)):
        raise ValueError(
            "run_strategy requires clients with cid == position "
            f"(0..{K - 1}); got {[c.cid for c in clients]}")
    _check_slice(strategy, cfg, clients, mesh=mesh,
                 checkpointed=checkpoint_path is not None
                 or resume_from is not None)
    faults_on = faults_active(clients)
    dev = resolve_device(device)
    # fail fast on the fold mode and the chaos knobs, before any state is
    # built
    associative = compile_lib.resolve_fold_affine(
        strategy, model, cfg_model, cfg, dev,
        faults_on=faults_on) is not None
    ucodec, uview = _check_chaos(strategy, model, cfg, faults_on)
    eval_report = resolve_eval_report(cfg)
    E, B = cfg.local_epochs, cfg.batch_size
    max_cohort = max_cohort if max_cohort is not None else cfg.max_cohort
    W = max(1, int(window if window is not None else cfg.window))

    starts = None  # per-client starting weights (Local-S)
    if init_params is None:
        w0 = model.init(torch.Generator().manual_seed(cfg.seed), device=dev)
    elif isinstance(init_params, Mapping):
        if strategy.per_client_init:
            raise ValueError(
                f"init_params: strategy {strategy.name!r} starts every "
                "client from its own draw (seed + cid), so it takes a "
                f"sequence of {K} per-client mappings, not one mapping")
        w0 = params_from_numpy(init_params, device=dev)
    else:
        if not strategy.per_client_init:
            raise ValueError(
                f"init_params: strategy {strategy.name!r} starts every "
                "client from one w0, so it takes one mapping, not a "
                "sequence of per-client mappings")
        if len(init_params) != K:
            raise ValueError(f"init_params: {len(init_params)} per-client "
                             f"mappings for {K} clients")
        starts = [params_from_numpy(p, device=dev) for p in init_params]
        w0 = starts[0]
    # simulated wire bytes of one arrival's encoded upload, which the
    # schedulers' bandwidth-metered delay draws consume; the sweep
    # baselines (Local-S, Global) upload nothing
    upload_bytes = ucodec.tree_bytes(w0) if uview is not None else 0.0
    client_slots = tuple(strategy.telemetry_slots(cfg))
    server_slots = tuple(strategy.server_telemetry_slots(cfg))
    # the engine-owned fold-depth slot rides between the two blocks; a
    # chaos tick appends the admission counts (tick_body's condition)
    slots = client_slots + ("folds_per_tick",) + server_slots
    chaos_tick = compile_lib.chaos_tick(strategy, model, cfg_model, cfg,
                                        faults_on)
    if chaos_tick:
        slots = slots + ("rejected_per_tick", "clipped_per_tick")
    drop = cfg.dropout_frac if strategy.uses_dropout else 0.0
    skip = cfg.periodic_dropout if strategy.uses_dropout else 0.0

    windowed = strategy.schedule == "async"
    if windowed:
        sched = AsyncScheduler(
            clients, seed=cfg.seed, dropout_frac=drop, skip_prob=skip,
            init_work=B, round_work=E * B,
            sim_time_budget=cfg.sim_time_budget, upload_bytes=upload_bytes,
        )
        active = sched.active
        pad = max(1, min(max_cohort or len(active), max(len(active), 1)))
    elif strategy.schedule == "sync":
        sched = SyncScheduler(
            clients, seed=cfg.seed, dropout_frac=drop, skip_prob=skip,
            participation=cfg.participation, round_work=E * B,
            upload_bytes=upload_bytes,
        )
        active = sched.active
        pad = sched.m
    else:  # sweep
        sched = SweepScheduler(clients)
        active = sched.active
        pad = 1 if strategy.pooled else K
    # Global trains one virtual member on pooled batches
    n_members = 1 if strategy.pooled else K
    members = [None] if strategy.pooled else clients
    scratch = n_members  # index of the scratch row targeted by padded slots

    def _n0(c: Optional[SimClient]) -> float:
        return float(c.stream.visible(0)) if c is not None else 0.0

    def _init_one(c: Optional[SimClient]):
        if starts is None:
            return strategy.init_client(model, cfg, w0, c)
        return strategy.init_client(model, cfg, w0, c, start=starts[c.cid])

    codec = strategy.state_codec(model, cfg, w0)
    init_batched = strategy.build_init_client(model, cfg)

    def init_rows(cs):
        """The encoded initial state rows of clients ``cs``."""
        n0 = np.array([_n0(c) for c in cs], np.float32)
        rows = init_batched(w0, torch.tensor(n0, device=dev))
        return rows if codec is None else codec.encode(rows)

    pool = None
    if cfg.state_residency == "host":
        if init_batched is None:
            raise ValueError(
                f"state_residency='host' needs {strategy.name!r} to "
                "provide build_init_client: the pool is filled by chunked "
                "batched init (a device-stacked init of all K rows is "
                "exactly what the host pool exists to avoid)")
        storage = resolve_state_storage(cfg.state_dtype)
        packed = (storage is not None and codec is not None
                  and storage.pool_bits == 4)
        tmpl = init_rows(members[:1])
        # the storage dtype of each leaf: the pool holds bf16 as int16
        leaf_dtypes = [x.dtype for x in tree_leaves(tmpl)]
        pool = HostStatePool(
            tree_map(lambda x: leaf_to_host(x[0]), tmpl), n_members,
            packed=packed, shards=min(cfg.state_shards, n_members))
        del tmpl
        # chunked init: the device holds one encoded chunk at a time on
        # its way into the pool
        CHUNK = 4096
        for start in range(0, n_members, CHUNK):
            pool.write_block(start, tree_map(
                leaf_to_host, init_rows(members[start:start + CHUNK])))
        stacked = None  # no device-resident stack: blocks ride per window
    elif init_batched is not None:
        stacked = init_rows(members + [members[0]])
    else:
        stacked = tree_stack([_init_one(c) for c in members + [members[0]]])
        if codec is not None:
            stacked = codec.encode(stacked)
    server = strategy.init_server(model, cfg_model, cfg, w0, clients, active)
    run_block = compile_lib.window_fn(strategy, model, cfg_model, cfg,
                                      client_slots, server_slots, dev,
                                      windowed=windowed, codec=codec,
                                      faults_on=faults_on, w0=w0)
    evaluator = Evaluator(model, clients, eval_report, dev,
                          per_client=strategy.eval_per_client) \
        if cfg.eval_every > 0 else None
    telem = telemetry if telemetry is not None else TelemetryLog(slots)
    if telem.slots != slots:
        telem.slots = slots  # caller-constructed logs adopt the run's slots
    by_id = {c.cid: c for c in clients}

    def transfer(name, arr):
        # a copy, never an alias: TickBuilder reuses its staging buffers.
        # Integer columns (indices, class labels) become int64 for
        # index_select / index_copy_ / gather.
        if np.issubdtype(arr.dtype, np.integer):
            return torch.tensor(arr, dtype=torch.int64, device=dev)
        return torch.tensor(arr, device=dev)

    builder = TickBuilder(
        by_id=by_id, batch_size=B, local_epochs=E, scratch=scratch, pad=pad,
        pooled=strategy.pooled, transfer=transfer, state_pool=pool,
    )

    def nbytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    # live device bytes of client state: the [K+1, ...] stack, or under
    # host residency the largest block dispatched (updated in `dispatch`)
    stacked_state_bytes = 0 if pool is not None else nbytes(stacked)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    resume_t, resume_sim_time = 0, 0.0
    if resume_from is not None:
        # the snapshot's device state replaces the fresh one (on this
        # run's device), its host cursor the fresh scheduler, streams
        # and staleness meter
        stacked, server, host = ckpt_lib.load_run_state(
            resume_from, stacked, server, pool=pool, device=dev)
        if host.get("strategy") != strategy.name \
                or int(host.get("seed", cfg.seed)) != cfg.seed:
            raise ValueError(
                f"snapshot at {resume_from!r} was written by "
                f"strategy={host.get('strategy')!r} "
                f"seed={host.get('seed')}; this run is "
                f"{strategy.name!r} seed={cfg.seed}")
        sched.load_state_dict(host["sched"])
        for cid_s, st_rng in host["streams"].items():
            by_id[int(cid_s)].stream.set_rng_state(st_rng)
        builder.staleness.load_state_dict(host["staleness"])
        resume_t, resume_sim_time = int(host["t"]), float(host["sim_time"])

    history: List[HistoryPoint] = []
    pending_evals: List[Tuple[int, float, float, Any]] = []
    device_s = 0.0
    eval_s = 0.0
    n_ticks, n_windows = 0, 0
    t, sim_time = resume_t, resume_sim_time
    n_uploads = 0  # arrivals of the sync and sweep schedules
    t0 = time.perf_counter()

    def eval_params():
        # host residency only serves central-model evaluation
        if pool is None and (strategy.eval_per_client or strategy.pooled):
            view = tree_map(lambda x: x[:n_members], stacked)
            return strategy.eval_params(
                server, view if codec is None else codec.decode(view))
        return strategy.eval_params(server)

    def record(t: int, sim_time: float):
        nonlocal eval_s
        if evaluator is None:
            return
        e0 = time.perf_counter()
        preds = evaluator.predict_device(eval_params())
        pending_evals.append((t, sim_time, time.perf_counter() - t0, preds))
        eval_s += time.perf_counter() - e0

    def dispatch(pt):
        nonlocal stacked, server, device_s, n_ticks, n_windows, \
            stacked_state_bytes
        d0 = time.perf_counter()
        if pool is not None:
            # host residency: repair the speculative gather (rows written
            # by scatters that landed after it), copy the block to the
            # device, run the window on it as the stacked carry and
            # scatter the updated member rows back into the pool
            pool.patch(pt.block, pt.block_cids, pt.gather_seq)
            block = tree_unflatten(pt.block, [
                leaf_to_device(a, dt, dev)
                for a, dt in zip(tree_leaves(pt.block), leaf_dtypes)])
            stacked_state_bytes = max(stacked_state_bytes, nbytes(block))
            with torch.no_grad():
                block, server, tel = run_block(block, server, pt)
        else:
            with torch.no_grad():
                stacked, server, tel = run_block(stacked, server, pt)
        if on_card:
            torch.cuda.synchronize(dev)
        if pool is not None:
            pool.scatter(pt.block_cids[:pt.block_rows],
                         tree_map(leaf_to_host, block))
        telem.append(pt, tel)
        device_s += time.perf_counter() - d0
        n_ticks += pt.n_ticks
        n_windows += 1

    def snapshot():
        # a copy: per-client params are views of the stacked state, which
        # later ticks overwrite in place
        return (t, {k: v.cpu().numpy().copy()
                    for k, v in eval_params().items()})

    use_prefetch = False
    ckpt_writes, ckpt_write_s, ckpt_bytes = 0, 0.0, 0
    if windowed:
        # a client with an empty local split can never train: its
        # arrivals are dropped so fabricated zero batches are never folded
        trainable = {c.cid for c in active if c.stream.n > 0}
        try:  # affinity respects container/cgroup CPU limits
            ncpu = len(os.sched_getaffinity(0))
        except AttributeError:
            ncpu = os.cpu_count() or 1
        use_prefetch = (prefetch if prefetch is not None
                        else cfg.prefetch if cfg.prefetch is not None
                        else on_card or ncpu >= 4)

        def produce():
            """Pop + filter + build each window (worker thread when
            prefetching) — the JAX engine's producer: same peek/commit
            speculation, same split of a window into same-bucket runs and
            power-of-two chunks, so every tick keeps the bucket a
            ``window=1`` run gives it, and the same checkpoint cursor."""
            tp = resume_t
            sim_prod = resume_sim_time
            kept_count = lambda tk: sum(  # noqa: E731
                a.cid in trainable for a in tk)
            while tp < cfg.T:
                snap = None
                if checkpoint_path is not None:
                    # the whole host cursor, taken at the one clean point:
                    # the previous window is committed (no speculation in
                    # flight) and no stream draw of the next window has
                    # been made.  It rides the window's first tick to the
                    # consumer, which saves it with the device state
                    # before dispatching that tick
                    snap = {
                        "t": tp, "sim_time": sim_prod,
                        "strategy": strategy.name, "seed": cfg.seed,
                        "state_residency": cfg.state_residency,
                        "sched": sched.state_dict(),
                        "streams": {str(c.cid): c.stream.rng_state()
                                    for c in active},
                        "staleness": builder.staleness.state_dict(),
                    }
                ticks = sched.peek_window(W, pad, total_limit=cfg.T - tp,
                                          count=kept_count)
                if not ticks:
                    sched.commit()
                    break  # drained or over the simulated-time budget
                kept = [[a for a in tk if a.cid in trainable]
                        for tk in ticks]
                kept = [tk for tk in kept if tk]
                sched.commit()
                if not kept:
                    continue  # window held only empty-split clients
                if cfg.eval_align and W > 1 and cfg.eval_every > 0:
                    segments = split_at_evals(kept, tp, cfg.eval_every,
                                              count=kept_count)
                else:
                    segments = [kept]
                for seg in segments:
                    groups: List[Tuple[int, List]] = []
                    for tk in seg:
                        b = bucket_size(len(tk), pad)
                        if groups and groups[-1][0] == b:
                            groups[-1][1].append(tk)
                        else:
                            groups.append((b, [tk]))
                    for _, g in groups:
                        i = 0
                        while i < len(g):
                            n = 1 << ((len(g) - i).bit_length() - 1)
                            chunk = g[i:i + n]
                            i += n
                            pt = builder.build_window(
                                chunk, t_start=tp, window=W,
                                sim_time=chunk[-1][-1].time)
                            tp = pt.t_end
                            sim_prod = pt.sim_time
                            if snap is not None:
                                pt.host_snapshot = snap
                                snap = None
                            yield pt

        if not trainable:
            source = iter(())
        elif use_prefetch:
            source = TickPrefetcher(produce(), depth=1)
        else:
            source = produce()
        next_eval = (resume_t // cfg.eval_every + 1) * cfg.eval_every \
            if cfg.eval_every > 0 else cfg.T + 1
        ckpt_every = int(checkpoint_every) if checkpoint_every \
            else (cfg.eval_every or cfg.T)
        next_ckpt = resume_t + ckpt_every if checkpoint_path is not None \
            else None
        try:
            for pt in source:
                if (next_ckpt is not None and pt.host_snapshot is not None
                        and pt.host_snapshot["t"] >= next_ckpt):
                    # write before dispatch: the state on disk is the
                    # state after the snapshot's t folds.  Under host
                    # residency the pool is the client-state payload, and
                    # every earlier window has scattered back into it
                    # (dispatch copies the block back synchronously); an
                    # asynchronous copy-back must wait on its event here
                    c0 = time.perf_counter()
                    ckpt_bytes = ckpt_lib.save_run_state(
                        checkpoint_path, stacked, server, pt.host_snapshot,
                        pool=pool)
                    ckpt_write_s += time.perf_counter() - c0
                    ckpt_writes += 1
                    next_ckpt = pt.host_snapshot["t"] + ckpt_every
                dispatch(pt)
                t = pt.t_end
                sim_time = pt.sim_time
                if trace is not None:
                    trace.append(snapshot())
                if t >= next_eval or t >= cfg.T:
                    record(t, sim_time)
                    while next_eval <= t:
                        next_eval += cfg.eval_every
        finally:
            if isinstance(source, TickPrefetcher):
                source.close()
    else:
        sync = strategy.schedule == "sync"
        for t in range(1, cfg.T + 1):
            if sync and cfg.sim_time_budget \
                    and sim_time > cfg.sim_time_budget:
                break
            arrivals, round_time = sched.next_round(now=sim_time)
            if not arrivals:
                if sync:
                    if not np.isfinite(round_time):
                        break  # fleet retired: no trace ever rejoins
                    # every participant skipped (round_time 0), or the
                    # whole fleet is off-window: the barrier still waits
                    # out the gap to the earliest rejoin edge
                    sim_time += round_time
                continue
            pooled = (strategy.pooled_batches(clients, t, cfg)
                      if strategy.pooled else None)
            if strategy.pooled:
                arrivals = arrivals[:1]
            # advance=False: a sync/sweep round's telemetry stamp is the
            # round index t itself, matching the eval history points
            pt = builder.build(arrivals, [t] * len(arrivals), sim_time,
                               pooled_batch=pooled, advance=False)
            dispatch(pt)
            n_uploads += len(arrivals)
            sim_time = sim_time + round_time if sync else float(t)
            if trace is not None:
                trace.append(snapshot())
            if (cfg.eval_every > 0 and t % cfg.eval_every == 0) \
                    or t == cfg.T:
                record(t, sim_time)

    e0 = time.perf_counter()
    for (te, ste, we, preds) in pending_evals:
        history.append(HistoryPoint(te, ste, we,
                                    evaluator.metrics_from(preds)))
    eval_s += time.perf_counter() - e0
    telem.finalize()
    if stats is not None:
        stats.update(
            ticks=n_ticks, windows=n_windows, iters=t, sim_time=sim_time,
            # wall seconds before the first window: state init (the
            # host pool's chunked fill), scheduler, evaluator, and the
            # load of a resumed snapshot
            setup_s=round(t0 - entry, 6),
            host_build_s=round(builder.host_build_s, 6),
            device_s=round(device_s, 6), eval_s=round(eval_s, 6),
            prefetch=bool(use_prefetch), devices=1,
            window=W if windowed else 1,
            device=str(dev),
            # "fp32" whenever no codec ran: a codec-less strategy stores
            # full-precision state whatever the config asked for
            state_dtype=str(cfg.state_dtype) if codec is not None
            else "fp32",
            state_residency="host" if pool is not None else "device",
            fold_mode="associative" if associative else "sequential",
            stacked_state_bytes=int(stacked_state_bytes),
            # the allocator's peak on the card (0: not measured on the CPU)
            peak_device_bytes=int(torch.cuda.max_memory_allocated(dev))
            if on_card else 0,
            # host-pool footprint and gather / patch / scatter traffic
            # (all zero under device residency: the stack never moves)
            host_pool_bytes=int(pool.nbytes) if pool is not None else 0,
            gathered_rows=int(pool.gathered_rows) if pool is not None else 0,
            scattered_rows=int(pool.scattered_rows) if pool is not None
            else 0,
            gather_s=round(pool.gather_s, 6) if pool is not None else 0.0,
            scatter_s=round(pool.scatter_s, 6) if pool is not None else 0.0,
            staleness_mean=round(builder.staleness.mean, 4),
            staleness_max=int(builder.staleness.max),
            availability_utilization=round(
                availability_utilization(active, sim_time), 4),
            deferred_arrivals=int(getattr(sched, "deferred", 0)),
            retired_clients=int(getattr(sched, "retired", 0)),
            # the schedulers' fault counters (0 for fault-free runs)
            lost_uploads=int(getattr(sched, "lost", 0)),
            retried_uploads=int(getattr(sched, "retried", 0)),
            crashed_clients=int(getattr(sched, "crashed", 0)),
            duplicated_arrivals=int(getattr(sched, "duplicated", 0)),
            corrupted_arrivals=int(getattr(sched, "corrupted", 0)),
            upload_codec=ucodec.name,
            upload_bytes=float(upload_bytes),
            # async iterations each fold exactly one upload
            upload_bytes_total=float(upload_bytes) * (
                t if windowed else n_uploads),
            ckpt_writes=ckpt_writes, ckpt_write_s=round(ckpt_write_s, 6),
            ckpt_bytes=int(ckpt_bytes),
        )
        if resume_from is not None:
            stats["resumed_from_t"] = resume_t
        for k, v in telem.summary().items():
            stats[k] = round(v, 6) if isinstance(v, float) else v
        if chaos_tick:
            # the in-tick admission counts, totalled over the run
            stats["rejected_uploads"] = int(round(sum(
                r.values.get("rejected_per_tick", 0.0)
                for r in telem.records)))
            stats["clipped_uploads"] = int(round(sum(
                r.values.get("clipped_per_tick", 0.0)
                for r in telem.records)))
    return history
