"""Cohort engine of the port: ``run_strategy`` for the async schedule.

Counterpart of ``repro.sim.engine`` for the first slice of the port: the
asynchronous schedule with the sequential server fold, the stacked
client state resident on the device, the identity state and upload
codecs, no faults or admission guards, one device.  The host layer —
scheduler, streams, staging buffers, prefetch thread, telemetry log —
is the JAX package's, copied unchanged, so both engines replay the same
arrival stream draw for draw; the device side is plain PyTorch plus the
hand-written CUDA feature-pass kernel.

The engine drains the scheduler in **ticks** (maximal runs of pending
arrivals with pairwise-distinct clients) grouped into **windows** of
``RunConfig.window`` ticks: the producer stages a whole window in one
block and transfers it once; the consumer runs the window's ticks in
order (``repro_torch.sim.compile``), each at the shape bucket it would
ride alone, so window size and prefetch never change a bit of the
trajectory.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``): with no card present ``run_strategy`` raises instead
of falling back.  Knobs outside this slice raise ``ValueError`` naming
the knob.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.client import state_tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.sim import compile as compile_lib
from repro_torch.sim.evaluation import Evaluator
from repro_torch.sim.prefetch import TickBuilder, TickPrefetcher, bucket_size
from repro_torch.sim.profiles import SimClient
from repro_torch.sim.scheduler import AsyncScheduler
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
    # FedAvg / FedProx (strategies not ported yet)
    participation: float = 0.2
    prox_mu: float = 0.0
    # FedAsync (not ported yet)
    fedasync_alpha: float = 0.6
    fedasync_staleness_exp: float = 0.5
    # FedBuff (not ported yet)
    buffer_size: int = 8
    fedbuff_lr: float = 1.0
    # engine
    max_cohort: Optional[int] = None  # cap on clients per tick (None: all)
    # build windows on a side thread (None: on for the card and >=4-core
    # CPU hosts; bit-identical either way)
    prefetch: Optional[bool] = None
    # `window` consecutive async ticks are staged and transferred as one
    # block and run back to back; `eval_align` splits windows at
    # `eval_every` fold boundaries.  `state_dtype`: only fp32 (None) in
    # this slice.
    window: int = 1
    eval_align: bool = False
    state_dtype: Optional[str] = None
    # only "device" in this slice
    state_residency: str = "device"
    state_shards: int = 1
    state_qclip: float = 0.5
    # feature pass: None = the device decides (CUDA kernel on the card,
    # plain version on the CPU); True / False must agree with the device
    feature_kernel: Optional[bool] = None
    # server fold: only "sequential" in this slice; `fold_kernel` belongs
    # to the associative fold (still to port)
    fold_mode: str = "sequential"
    fold_kernel: Optional[bool] = None
    # upload compression: only "identity" in this slice
    upload_codec: str = "identity"
    upload_frac: float = 0.1
    upload_bits: int = 8
    # admission guards (chaos layer): not in this slice
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
      for ONE arrival (``idx``/``n_vis``/``t_arr`` are 1-element tensors)
    * merge(state, received) -> state   (post-fold download, stacked)
    """

    name: str = "base"
    schedule: str = "async"  # only "async" is ported

    def telemetry_slots(self, cfg: RunConfig) -> Tuple[str, ...]:
        return ("train_loss",)

    def init_client(self, model, cfg: RunConfig, w0,
                    client: Optional[SimClient]):
        raise NotImplementedError

    def build_init_client(self, model, cfg: RunConfig):
        """``(w0, n0 of shape (R,)) -> stacked client state`` of R rows."""
        raise NotImplementedError

    def init_server(self, model, cfg_model, cfg: RunConfig, w0,
                    clients: Sequence[SimClient],
                    active: Sequence[SimClient]):
        return {}

    def build_local(self, model, cfg: RunConfig):
        raise NotImplementedError

    def build_fold(self, model, cfg_model, cfg: RunConfig):
        return None

    def build_merge(self, model, cfg: RunConfig):
        return lambda state, received: state

    def server_broadcast(self, server):
        return server

    def eval_params(self, server):
        return server["w"]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The run's device: ``None`` means the CUDA card, and without one
    this raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain-PyTorch path on the CPU")
    return dev


def _check_slice(strategy: Strategy, cfg: RunConfig,
                 clients: Sequence[SimClient], *, mesh, checkpoint_path,
                 resume_from) -> None:
    """Raise ``ValueError`` naming the first knob outside this slice."""
    def refuse(knob: str, value, accepted: str):
        raise ValueError(
            f"{knob}={value!r} is not ported yet (the port runs {accepted})")

    if strategy.schedule != "async":
        refuse("strategy.schedule", strategy.schedule, "'async' strategies")
    if cfg.fold_mode != "sequential":
        refuse("fold_mode", cfg.fold_mode, "fold_mode='sequential'")
    if cfg.state_residency != "device":
        refuse("state_residency", cfg.state_residency,
               "state_residency='device'")
    if cfg.state_dtype not in (None, "fp32", "float32"):
        refuse("state_dtype", cfg.state_dtype, "fp32 client state")
    if cfg.upload_codec != "identity":
        refuse("upload_codec", cfg.upload_codec, "upload_codec='identity'")
    if cfg.max_staleness is not None:
        refuse("max_staleness", cfg.max_staleness, "no admission guards")
    if cfg.max_delta_norm is not None:
        refuse("max_delta_norm", cfg.max_delta_norm, "no admission guards")
    if any(c.profile.faults is not None and c.profile.faults.active
           for c in clients):
        refuse("profile.faults", "active", "fault-free clients")
    if checkpoint_path is not None:
        refuse("checkpoint_path", checkpoint_path, "without checkpoints")
    if resume_from is not None:
        refuse("resume_from", resume_from, "without checkpoints")
    if mesh is not None:
        refuse("mesh", mesh, "on a single device")
    if cfg.eval_every < 0:
        raise ValueError(
            f"eval_every must be >= 0 (0 disables evaluation), "
            f"got {cfg.eval_every}")


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
    resume_from: Optional[str] = None,
    device=None,
    init_params: Optional[Mapping[str, Any]] = None,
) -> List[HistoryPoint]:
    """Run one algorithm through the port's cohort engine.

    Same contract as ``repro.sim.engine.run_strategy`` for the slice it
    covers.  ``device`` is the run's device (None: the CUDA card).
    ``init_params`` (a name -> array mapping, e.g. the JAX package's
    ``w0`` as numpy) replaces the seeded draw of the starting weights, so
    a test can start both engines from the same ``w0``.  ``trace``, when
    a list, receives ``(t, {name: numpy server weight})`` after every
    window; ``stats``, when a dict, is filled with the run's counters and
    per-phase wall times; ``telemetry`` receives one record per tick.
    """
    clients = list(clients)
    K = len(clients)
    if [c.cid for c in clients] != list(range(K)):
        raise ValueError(
            "run_strategy requires clients with cid == position "
            f"(0..{K - 1}); got {[c.cid for c in clients]}")
    _check_slice(strategy, cfg, clients, mesh=mesh,
                 checkpoint_path=checkpoint_path, resume_from=resume_from)
    dev = resolve_device(device)
    eval_report = resolve_eval_report(cfg)
    E, B = cfg.local_epochs, cfg.batch_size
    max_cohort = max_cohort if max_cohort is not None else cfg.max_cohort
    W = max(1, int(window if window is not None else cfg.window))

    if init_params is not None:
        w0 = params_from_numpy(init_params, device=dev)
    else:
        w0 = model.init(torch.Generator().manual_seed(cfg.seed), device=dev)
    # identity upload codec: one arrival transmits the fp32 delta
    upload_bytes = float(sum(v.numel() * v.element_size()
                             for v in w0.values()))
    client_slots = tuple(strategy.telemetry_slots(cfg))
    slots = client_slots + ("folds_per_tick",)

    sched = AsyncScheduler(
        clients, seed=cfg.seed, dropout_frac=cfg.dropout_frac,
        skip_prob=cfg.periodic_dropout, init_work=B, round_work=E * B,
        sim_time_budget=cfg.sim_time_budget, upload_bytes=upload_bytes,
    )
    active = sched.active
    pad = max(1, min(max_cohort or len(active), max(len(active), 1)))
    scratch = K  # index of the scratch row targeted by padded slots

    def _n0(c: SimClient) -> float:
        return float(c.stream.visible(0))

    n0s = np.array([_n0(c) for c in clients] + [_n0(clients[0])],
                   np.float32)
    stacked = strategy.build_init_client(model, cfg)(
        w0, torch.tensor(n0s, device=dev))
    server = strategy.init_server(model, cfg_model, cfg, w0, clients, active)
    run_window = compile_lib.window_fn(strategy, model, cfg_model, cfg,
                                       client_slots)
    evaluator = Evaluator(model, clients, eval_report, dev) \
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
        pooled=False, transfer=transfer,
    )
    stacked_state_bytes = sum(
        x.numel() * x.element_size() for x in state_tree(stacked).values())
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    history: List[HistoryPoint] = []
    pending_evals: List[Tuple[int, float, float, Any]] = []
    device_s = 0.0
    eval_s = 0.0
    n_ticks, n_windows, t, sim_time = 0, 0, 0, 0.0
    t0 = time.perf_counter()

    def record(t: int, sim_time: float):
        nonlocal eval_s
        if evaluator is None:
            return
        e0 = time.perf_counter()
        preds = evaluator.predict_device(strategy.eval_params(server))
        pending_evals.append((t, sim_time, time.perf_counter() - t0, preds))
        eval_s += time.perf_counter() - e0

    def dispatch(pt):
        nonlocal stacked, server, device_s, n_ticks, n_windows
        d0 = time.perf_counter()
        with torch.no_grad():
            stacked, server, tel = run_window(stacked, server, pt)
        if on_card:
            torch.cuda.synchronize(dev)
        telem.append(pt, tel)
        device_s += time.perf_counter() - d0
        n_ticks += pt.n_ticks
        n_windows += 1

    # a client with an empty local split can never train: its arrivals
    # are dropped so fabricated zero batches are never folded in
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
        prefetching) — the JAX engine's producer, without the checkpoint
        snapshot: same peek/commit speculation, same split of a window
        into same-bucket runs and power-of-two chunks, so every tick
        keeps the bucket a ``window=1`` run gives it."""
        tp = 0
        kept_count = lambda tk: sum(  # noqa: E731
            a.cid in trainable for a in tk)
        while tp < cfg.T:
            ticks = sched.peek_window(W, pad, total_limit=cfg.T - tp,
                                      count=kept_count)
            if not ticks:
                sched.commit()
                break  # drained or over the simulated-time budget
            kept = [[a for a in tk if a.cid in trainable] for tk in ticks]
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
                        yield pt

    if not trainable:
        source = iter(())
    elif use_prefetch:
        source = TickPrefetcher(produce(), depth=1)
    else:
        source = produce()
    next_eval = cfg.eval_every if cfg.eval_every > 0 else cfg.T + 1
    try:
        for pt in source:
            dispatch(pt)
            t = pt.t_end
            sim_time = pt.sim_time
            if trace is not None:
                trace.append((t, {k: v.cpu().numpy() for k, v in
                                  strategy.eval_params(server).items()}))
            if t >= next_eval or t >= cfg.T:
                record(t, sim_time)
                while next_eval <= t:
                    next_eval += cfg.eval_every
    finally:
        if isinstance(source, TickPrefetcher):
            source.close()

    e0 = time.perf_counter()
    for (te, ste, we, preds) in pending_evals:
        history.append(HistoryPoint(te, ste, we,
                                    evaluator.metrics_from(preds)))
    eval_s += time.perf_counter() - e0
    telem.finalize()
    if stats is not None:
        stats.update(
            ticks=n_ticks, windows=n_windows, iters=t, sim_time=sim_time,
            host_build_s=round(builder.host_build_s, 6),
            device_s=round(device_s, 6), eval_s=round(eval_s, 6),
            prefetch=bool(use_prefetch), devices=1, window=W,
            device=str(dev), state_dtype="fp32", state_residency="device",
            stacked_state_bytes=int(stacked_state_bytes),
            # the allocator's peak on the card (0: not measured on the CPU)
            peak_device_bytes=int(torch.cuda.max_memory_allocated(dev))
            if on_card else 0,
            staleness_mean=round(builder.staleness.mean, 4),
            staleness_max=int(builder.staleness.max),
            availability_utilization=round(
                availability_utilization(active, sim_time), 4),
            deferred_arrivals=int(sched.deferred),
            retired_clients=int(sched.retired),
            upload_codec="identity",
            upload_bytes=upload_bytes,
            upload_bytes_total=upload_bytes * t,
        )
        for k, v in telem.summary().items():
            stats[k] = round(v, 6) if isinstance(v, float) else v
    return history
