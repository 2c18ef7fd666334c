"""Sequential per-arrival reference loops: the port's own oracle.

Counterparts of ``repro.sim.reference``, driven by the same copied
:class:`~repro_torch.sim.scheduler.AsyncScheduler` (``SyncScheduler`` for
FedAvg/FedProx), so the event stream matches the cohort engine's arrival
for arrival.  They keep the seed's dispatch pattern — for each arrival a
local round (the engine's batched local math at a cohort of one), eager
delta ops, the server fold (``repro_torch.core.server.aggregate`` for
ASO-Fed: on the card one launch of the per-row feature-pass kernel a
fold), and a blocking host read — which makes them both the numerical
oracle for the engine's equivalence tests and the honest per-arrival
baseline for throughput.

They cover every state codec (``state_dtype``: each stored row makes
the engine's ``decode(encode(.))`` round trip), every upload codec
(``upload_codec``: each arrival's wire delta round-trips through it under
the slot key the engine derives) and the chaos layer: crash rejoin,
wire corruption, duplicate delivery (folded twice) and the admission
guards, decided one arrival at a time on the host from the same helpers
the engine's tick uses.  Every entry point takes ``device`` (None: the
CUDA card) and ``init_params`` (a name -> array mapping that replaces the
seeded draw of ``w0``), and returns ``{t: {name: numpy weight}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.common.dtypes import resolve_state_dtype
from repro_torch.common.pytree import (tree_axpy, tree_map, tree_sub,
                                       tree_zeros_like)
from repro_torch.core import client as client_lib
from repro_torch.core.algorithms.common import (admission,
                                                avg_surrogate_grad,
                                                corrupt_wire_delta,
                                                corruption_key,
                                                resolve_upload_codec,
                                                sgd_epochs, upload_keys)
from repro_torch.core.server import aggregate, init_server
from repro_torch.models.convert import params_from_numpy
from repro_torch.sim.engine import RunConfig, faults_active, stack_batches
from repro_torch.sim.prefetch import StalenessMeter
from repro_torch.sim.scheduler import AsyncScheduler, SyncScheduler
from repro_torch.sim.traces import utilization
from repro_torch.sim.workloads import resolve_eval_report


class _ChurnStats:
    """Staleness + availability bookkeeping for the oracle loops, built
    on the same :class:`StalenessMeter` the engine's ``TickBuilder``
    uses, so stats dicts are comparable across engine and reference."""

    def __init__(self):
        self.meter = StalenessMeter()
        self.sim_time = 0.0

    def arrival(self, cid: int, t: int, time: float) -> int:
        stal = self.meter.observe(cid, t)
        self.sim_time = time
        return stal  # the admission-guard staleness (engine's stal column)

    def update(self, stats: Dict, sched: AsyncScheduler) -> None:
        stats.update(
            staleness_mean=round(self.meter.mean, 4),
            staleness_max=int(self.meter.max),
            sim_time=self.sim_time,
            availability_utilization=round(
                utilization(sched.active, self.sim_time), 4),
            deferred_arrivals=int(sched.deferred),
            retired_clients=int(sched.retired),
        )


def _check_knobs(cfg: RunConfig) -> None:
    """The engine's validation of the knobs the oracles read, with its
    messages: the state dtype, the upload codec, the staleness policy."""
    resolve_state_dtype(cfg.state_dtype)
    resolve_upload_codec(cfg)
    if cfg.staleness_policy not in ("reject", "downweight"):
        raise ValueError(
            f"unknown staleness_policy {cfg.staleness_policy!r}; "
            "accepted: 'reject' | 'downweight'")


def _setup(model, cfg: RunConfig, clients, device,
           init_params: Optional[Mapping[str, Any]]):
    """(device, w0, one arrival's upload bytes) after the knob check."""
    _check_knobs(cfg)
    dev = resolve_device(device)
    if init_params is not None:
        w0 = params_from_numpy(init_params, device=dev)
    else:
        w0 = model.init(torch.Generator().manual_seed(cfg.seed), device=dev)
    # simulated wire bytes of one arrival's encoded upload
    return dev, w0, resolve_upload_codec(cfg).tree_bytes(w0)


def _upload_encoder(cfg: RunConfig, dev: torch.device):
    """Per-arrival oracle of the engine's in-tick upload compression:
    ``enc(delta, t, cid) -> delta'`` round-tripping one wire delta through
    the run's ``UploadCodec`` as a cohort of one, under the slot key the
    engine's tick derives (``fold_in(fold_in(PRNGKey(seed), t), cid)``),
    so both mask the same coordinates.  None for the identity codec."""
    codec = resolve_upload_codec(cfg)
    if codec.identity:
        return None
    key0 = prng.prng_key(cfg.seed, dev)

    def enc(delta, t: int, cid: int):
        keys = (upload_keys(key0, *_stamp(t, cid, dev))
                if codec.uses_rng else None)
        return _first(codec.encode(_one(delta), keys))

    return enc


def _stamp(t: int, cid: int, dev: torch.device):
    """(t, cid) as the (1,) columns of a cohort of one."""
    return (torch.tensor([float(t)], dtype=torch.float32, device=dev),
            torch.tensor([cid], dtype=torch.int64, device=dev))


class _ChaosTools:
    """Per-arrival oracle of the engine tick's chaos ops: the wire
    corruption and the server's admission guard, from the same helpers
    the tick uses (``corrupt_wire_delta``, ``corruption_key``, the guard's
    fp32 arithmetic) on a cohort of one, so every admit / clip decision
    and every corrupted payload matches the engine's."""

    def __init__(self, cfg: RunConfig, dev: torch.device):
        self.cfg, self.dev = cfg, dev
        self.key0 = prng.prng_key(cfg.seed, dev)
        # admission counts, as the engine's stats total them
        self.rejected = self.clipped = 0

    def corrupt(self, delta, code: int, t: int, cid: int):
        """The arrival's corrupted wire delta (the delta itself when
        ``code`` is 0: the engine's ``where`` selects the original)."""
        if not code:
            return delta
        keys = corruption_key(self.key0, *_stamp(t, cid, self.dev))
        return _first(corrupt_wire_delta(
            _one(delta), torch.tensor([code], device=self.dev), keys))

    def guard(self, delta, stal: int):
        """(admit, scale): the tick's admission decision for one arrival,
        read on the host.  ``scale < 1``: the caller folds
        ``self.scale(delta, scale)`` instead (norm clip / staleness
        downweight); an admitted ``scale >= 1`` arrival folds its delta
        untouched."""
        ok, sc = admission(_one(delta), torch.tensor(
            [float(stal)], dtype=torch.float32, device=self.dev), self.cfg)
        admit = bool(ok[0])
        self.rejected += not admit
        self.clipped += admit and float(sc[0]) < 1.0
        return admit, sc[0]

    def scale(self, delta, sc: torch.Tensor):
        return tree_map(lambda x: x * sc, delta)


def _chaos_tools(cfg: RunConfig, clients, dev: torch.device
                 ) -> Optional[_ChaosTools]:
    """The run's :class:`_ChaosTools`, or None when no client carries an
    active FaultSpec and no admission knob is set (the engine's ``chaos``
    flag), so fault-free oracle loops run the ops they ran before."""
    guards = cfg.max_staleness is not None or cfg.max_delta_norm is not None
    return (_ChaosTools(cfg, dev) if faults_active(clients) or guards
            else None)


def _state_roundtripper(cfg: RunConfig, alg: str, model, w0):
    """Per-arrival oracle of the engine's reduced-precision *stored*
    client state: ``decode(encode(state))`` through the strategy's
    codec, applied wherever the engine would scatter a row back encoded.
    Idempotent (quantized codes are stable under re-encode).  None for
    the identity (fp32) codec, which leaves the loops untouched."""
    from repro_torch.core.algorithms import get_strategy

    codec = get_strategy(alg).state_codec(model, cfg, w0)
    if codec is None:
        return None
    return lambda st: codec.decode(codec.encode(st))


def _stale_copy_roundtripper(cfg: RunConfig, alg: str, model, w0):
    """FedAsync's / FedBuff's round trip of one stored stale copy:
    ``(w, version) -> w``."""
    srt = _state_roundtripper(cfg, alg, model, w0)
    if srt is None:
        return lambda wl, v: wl
    dev = next(iter(w0.values())).device
    return lambda wl, v: srt({"w": wl, "version": torch.tensor(
        float(v), dtype=torch.float32, device=dev)})["w"]


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The engine's transfer: integer columns become int64."""
    if np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(arr, dtype=torch.int64, device=dev)
    return torch.tensor(arr, device=dev)


def _batches(c, t: int, cfg: RunConfig, dev: torch.device):
    """One client's (1, E, B, ...) round of minibatches on the device: a
    cohort of one for the engine's batched local math."""
    xs, ys = stack_batches(c.stream, t, cfg.batch_size, cfg.local_epochs)
    return _to_device(xs[None], dev), _to_device(ys[None], dev)


def _one(tree):
    """A client's tree as a cohort of one (leading axis of size 1)."""
    return tree_map(lambda v: v[None], tree)


def _first(tree):
    return tree_map(lambda v: v[0], tree)


def _host(w) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in w.items()}


def _eval_all_per_client(model, params, clients, cfg: RunConfig,
                         dev: torch.device):
    """The seed's ``_eval_all``: K separate predict round-trips, reduced
    with the run's metric bundle (workload-aware, like the engine)."""
    preds, targets = [], []
    with torch.no_grad():
        for c in clients:
            p = model.predict(params, {"x": torch.tensor(c.test_x,
                                                         device=dev)})
            preds.append(p.cpu().numpy())
            targets.append(c.test_y)
    return resolve_eval_report(cfg)(np.concatenate(preds),
                                    np.concatenate(targets))


def _evaluates(cfg: RunConfig, t: int) -> bool:
    return cfg.eval_every > 0 and (t % cfg.eval_every == 0 or t == cfg.T)


def _make_scheduler(clients, cfg: RunConfig,
                    upload_bytes: float = 0.0) -> AsyncScheduler:
    return AsyncScheduler(
        clients, seed=cfg.seed, dropout_frac=cfg.dropout_frac,
        skip_prob=cfg.periodic_dropout, init_work=cfg.batch_size,
        round_work=cfg.local_epochs * cfg.batch_size,
        sim_time_budget=cfg.sim_time_budget, upload_bytes=upload_bytes,
    )


def _upload_stats(stats: Dict, cfg: RunConfig, nbytes: float,
                  n_uploads: int, chaos: Optional[_ChaosTools]) -> None:
    """The engine's resource-accounting and admission stats columns,
    oracle-side."""
    stats.update(upload_codec=resolve_upload_codec(cfg).name,
                 upload_bytes=float(nbytes),
                 upload_bytes_total=float(nbytes) * n_uploads)
    if chaos is not None:
        stats.update(rejected_uploads=chaos.rejected,
                     clipped_uploads=chaos.clipped)


def run_asofed_reference(model, cfg_model, clients, cfg: RunConfig, *,
                         collect_trace: bool = True,
                         stats: Optional[Dict] = None,
                         losses: Optional[Dict[int, float]] = None,
                         device=None,
                         init_params: Optional[Mapping[str, Any]] = None
                         ) -> Dict[int, Dict[str, np.ndarray]]:
    """ASO-Fed, one arrival at a time.  Returns {t: server w (numpy)}.

    ``losses``, when a dict, receives the per-arrival surrogate train
    loss keyed by the fold's global iteration — the host-side oracle the
    engine's in-tick telemetry is tested against.
    """
    dev, w0, upload_bytes = _setup(model, cfg, clients, device, init_params)
    sched = _make_scheduler(clients, cfg, upload_bytes)
    active = sched.active
    server = init_server(w0, [c.cid for c in active],
                         {c.cid: c.stream.visible(0) for c in active},
                         keep_copies=False)
    cstate = {c.cid: client_lib.init_client_state(w0, c.stream.visible(0))
              for c in active}
    srt = _state_roundtripper(cfg, "asofed", model, w0)
    if srt is not None:  # the engine stores the initial stack encoded
        cstate = {cid: srt(st) for cid, st in cstate.items()}
    grad_fn = avg_surrogate_grad(model, cfg)
    n_evals = n_folds = 0

    def local_round(st, xs, ys, delay, n_new):
        g, loss = grad_fn(_one(st.params), _one(st.server_params), xs, ys)
        g = _first(g)
        zeta = tree_map(lambda gs, vp, hp: gs - vp + hp, g, st.v, st.h)
        r = (client_lib.dynamic_multiplier(st.delay_sum, st.rounds, delay)
             if cfg.dynamic_lr else torch.ones((), device=dev))
        new_params = tree_axpy(-r * cfg.eta, zeta, st.params)
        new_h = tree_map(lambda hp, vp: cfg.beta * hp + (1 - cfg.beta) * vp,
                         st.h, st.v)
        return dataclasses.replace(
            st, params=new_params, h=new_h, v=g,
            delay_sum=st.delay_sum + delay, rounds=st.rounds + 1.0,
            n_samples=st.n_samples + n_new,
        ), loss[0]

    trainable = {c.cid for c in active if c.stream.n > 0}
    enc = _upload_encoder(cfg, dev)
    chaos = _chaos_tools(cfg, clients, dev)
    traj: Dict[int, Dict[str, np.ndarray]] = {}
    churn = _ChurnStats()
    t = 0
    while t < cfg.T and trainable:
        tick = sched.next_tick(1)
        if not tick:
            break
        (a,) = tick
        if a.cid not in trainable:  # empty split: engine drops it too
            continue
        stal = churn.arrival(a.cid, t, a.time)
        c = sched.by_id[a.cid]
        st = cstate[a.cid]
        n_vis = c.stream.visible(t)
        if a.fresh:  # crash rejoin: the device lost its local state
            st = client_lib.init_client_state(w0, n_vis)
        n_new = max(n_vis - float(st.n_samples), 0.0)  # blocking host read
        xs, ys = _batches(c, t, cfg, dev)
        st_before = st.params
        st, loss = local_round(
            st, xs, ys, torch.tensor(a.delay, dtype=torch.float32,
                                     device=dev),
            torch.tensor(n_new, dtype=torch.float32, device=dev))
        if losses is not None:
            losses[t] = float(loss)  # keyed by the pre-fold iteration stamp
        delta = tree_sub(st_before, st.params)
        if enc is not None:  # lossy upload: the engine's (seed, t, cid) key
            delta = enc(delta, t, a.cid)
        admit = True
        if chaos is not None:
            delta = chaos.corrupt(delta, a.corrupt, t, a.cid)
            admit, sc = chaos.guard(delta, stal)
            if admit and float(sc) < 1.0:
                delta = chaos.scale(delta, sc)
        if admit:
            # a duplicated delivery folds the same upload twice but takes
            # one global iteration (t is set back)
            t_once = server.t + 1
            for _ in range(2 if a.dup else 1):
                n_folds += 1
                server = aggregate(  # eager delta + the server fold
                    server, a.cid, delta, n_vis, cfg_model,
                    upload_is_delta=True,
                    feature_learning=cfg.feature_learning,
                    use_kernel=cfg.feature_kernel)
            server = dataclasses.replace(server, t=t_once)
            cstate[a.cid] = client_lib.receive_server_model(st, server.w)
        else:
            # rejected: no fold, no download; the client keeps its
            # post-round state and the iteration stamp still advances
            server = dataclasses.replace(server, t=server.t + 1)
            cstate[a.cid] = st
        t = server.t
        if srt is not None:  # the row is scattered back encoded
            cstate[a.cid] = srt(cstate[a.cid])
        if collect_trace:
            traj[t] = _host(server.w)
        if _evaluates(cfg, t):
            n_evals += 1
            _eval_all_per_client(model, server.w, clients, cfg, dev)
    if stats is not None:
        stats.update(iters=t, ticks=t, evals=n_evals)
        churn.update(stats, sched)
        _upload_stats(stats, cfg, upload_bytes, t, chaos)
        if chaos is not None:  # server folds: a duplicate folds twice
            stats["folds"] = n_folds
    return traj


def run_fedasync_reference(model, cfg_model, clients, cfg: RunConfig, *,
                           collect_trace: bool = True,
                           stats: Optional[Dict] = None,
                           losses: Optional[Dict[int, float]] = None,
                           device=None,
                           init_params: Optional[Mapping[str, Any]] = None
                           ) -> Dict[int, Dict[str, np.ndarray]]:
    """FedAsync, one arrival at a time.  Returns {t: server w (numpy)}.

    ``losses`` collects the per-arrival mean epoch loss (telemetry
    oracle), keyed like the asofed reference.
    """
    dev, w, upload_bytes = _setup(model, cfg, clients, device, init_params)
    sched = _make_scheduler(clients, cfg, upload_bytes)
    sgd = sgd_epochs(model, cfg, mu=0.005)
    w0_init = w
    rt_w = _stale_copy_roundtripper(cfg, "fedasync", model, w)
    version = {c.cid: 0 for c in sched.active}
    local_w = {c.cid: rt_w(w, 0) for c in sched.active}
    trainable = {c.cid for c in sched.active if c.stream.n > 0}
    enc = _upload_encoder(cfg, dev)
    chaos = _chaos_tools(cfg, clients, dev)
    traj: Dict[int, Dict[str, np.ndarray]] = {}
    churn = _ChurnStats()
    t, n_evals = 0, 0
    while t < cfg.T and trainable:
        tick = sched.next_tick(1)
        if not tick:
            break
        (a,) = tick
        if a.cid not in trainable:  # empty split: engine drops it too
            continue
        stal = churn.arrival(a.cid, t, a.time)
        c = sched.by_id[a.cid]
        if a.fresh:  # crash rejoin: stale copy and version back to init
            local_w[a.cid] = w0_init
            version[a.cid] = 0
        xs, ys = _batches(c, t, cfg, dev)
        wk, loss = sgd(_one(local_w[a.cid]), _one(local_w[a.cid]), xs, ys)
        wk = _first(wk)
        if losses is not None:
            losses[t] = float(loss[0])
        admit = True
        if enc is not None or chaos is not None:
            # wire delta: the local progress against the stale copy; the
            # upload is recomposed only where the delta changed, so clean
            # identity-codec arrivals stay bitwise (w + (wk - w) != wk)
            d = tree_sub(wk, local_w[a.cid])
            modified = False
            if enc is not None:
                d = enc(d, t, a.cid)
                modified = True
            if chaos is not None:
                if a.corrupt:
                    d = chaos.corrupt(d, a.corrupt, t, a.cid)
                    modified = True
                admit, sc = chaos.guard(d, stal)
                if admit and float(sc) < 1.0:
                    d = chaos.scale(d, sc)
                    modified = True
            if modified:
                wk = tree_map(torch.add, local_w[a.cid], d)
        if admit:
            staleness = t - version[a.cid]
            alpha_t = cfg.fedasync_alpha * (1.0 + staleness) ** (
                -cfg.fedasync_staleness_exp)
            # a duplicated delivery mixes the same upload twice
            for _ in range(2 if a.dup else 1):
                w = tree_map(lambda x, y: (1 - alpha_t) * x + alpha_t * y,
                             w, wk)
            t += 1
            version[a.cid] = t
            local_w[a.cid] = w
        else:
            # rejected: no mix, no download; the stale copy and version
            # stay, and the iteration stamp still advances
            t += 1
        # the row is scattered back encoded
        local_w[a.cid] = rt_w(local_w[a.cid], version[a.cid])
        if collect_trace:
            traj[t] = _host(w)
        if _evaluates(cfg, t):
            n_evals += 1
            _eval_all_per_client(model, w, clients, cfg, dev)
    if stats is not None:
        stats.update(iters=t, ticks=t, evals=n_evals)
        churn.update(stats, sched)
        _upload_stats(stats, cfg, upload_bytes, t, chaos)
    return traj


def run_fedbuff_reference(model, cfg_model, clients, cfg: RunConfig, *,
                          collect_trace: bool = True,
                          stats: Optional[Dict] = None,
                          losses: Optional[Dict[int, float]] = None,
                          device=None,
                          init_params: Optional[Mapping[str, Any]] = None
                          ) -> Dict[int, Dict[str, np.ndarray]]:
    """FedBuff, one arrival at a time.  Returns {t: server w (numpy)}.

    Mirrors the engine's sequential fold exactly: every arrival deposits
    a ``1/sqrt(1+staleness)``-weighted delta into a buffer; every
    ``cfg.buffer_size``-th deposit flushes one fused server step
    ``w <- w - fedbuff_lr/M * buf`` and clears the buffer.  Clients
    always download the current central model.
    """
    dev, w, upload_bytes = _setup(model, cfg, clients, device, init_params)
    sched = _make_scheduler(clients, cfg, upload_bytes)
    sgd = sgd_epochs(model, cfg, mu=0.0)
    w0_init = w
    rt_w = _stale_copy_roundtripper(cfg, "fedbuff", model, w)
    version = {c.cid: 0 for c in sched.active}
    local_w = {c.cid: rt_w(w, 0) for c in sched.active}
    trainable = {c.cid for c in sched.active if c.stream.n > 0}
    M = int(cfg.buffer_size)
    buf = tree_zeros_like(w)
    count = 0
    enc = _upload_encoder(cfg, dev)
    chaos = _chaos_tools(cfg, clients, dev)
    traj: Dict[int, Dict[str, np.ndarray]] = {}
    churn = _ChurnStats()
    t, n_evals = 0, 0
    while t < cfg.T and trainable:
        tick = sched.next_tick(1)
        if not tick:
            break
        (a,) = tick
        if a.cid not in trainable:  # empty split: engine drops it too
            continue
        stal = churn.arrival(a.cid, t, a.time)
        c = sched.by_id[a.cid]
        if a.fresh:  # crash rejoin: stale copy and version back to init
            local_w[a.cid] = w0_init
            version[a.cid] = 0
        xs, ys = _batches(c, t, cfg, dev)
        wk, loss = sgd(_one(local_w[a.cid]), _one(local_w[a.cid]), xs, ys)
        wk = _first(wk)
        if losses is not None:
            losses[t] = float(loss[0])
        staleness = t - version[a.cid]
        s_w = float(1.0 / np.sqrt(1.0 + np.float32(staleness)))
        delta = tree_sub(local_w[a.cid], wk)
        if enc is not None:  # the buffered deposit is the wire delta
            delta = enc(delta, t, a.cid)
        admit = True
        if chaos is not None:
            if a.corrupt:
                delta = chaos.corrupt(delta, a.corrupt, t, a.cid)
            admit, sc = chaos.guard(delta, stal)
            if admit and float(sc) < 1.0:
                delta = chaos.scale(delta, sc)
        if admit:
            # a duplicated delivery deposits twice (the count runs twice,
            # so a flush can land between the two deposits)
            for _ in range(2 if a.dup else 1):
                buf = tree_axpy(s_w, delta, buf)
                count += 1
                if count >= M:
                    w = tree_axpy(-cfg.fedbuff_lr / M, buf, w)
                    buf = tree_zeros_like(w)
                    count = 0
            t += 1
            version[a.cid] = t
            local_w[a.cid] = w
        else:
            # rejected: no deposit, no download; the iteration stamp still
            # advances
            t += 1
        # the row is scattered back encoded
        local_w[a.cid] = rt_w(local_w[a.cid], version[a.cid])
        if collect_trace:
            traj[t] = _host(w)
        if _evaluates(cfg, t):
            n_evals += 1
            _eval_all_per_client(model, w, clients, cfg, dev)
    if stats is not None:
        stats.update(iters=t, ticks=t, evals=n_evals)
        churn.update(stats, sched)
        _upload_stats(stats, cfg, upload_bytes, t, chaos)
    return traj


def run_fedavg_reference(model, cfg_model, clients, cfg: RunConfig, *,
                         prox_mu: float = 0.0,
                         collect_trace: bool = True,
                         stats: Optional[Dict] = None,
                         device=None,
                         init_params: Optional[Mapping[str, Any]] = None
                         ) -> Dict[int, Dict[str, np.ndarray]]:
    """FedAvg/FedProx, one local round per participant per round, with
    the seed's direct weighted mean.  Returns {round t: server w}.

    The round barrier is trace-aware: ``next_round(now=sim_time)`` samples
    only on-window clients, and an all-off round pays the wait to the
    earliest rejoin edge, mirroring the engine's sync loop step for step.
    """
    dev, w, upload_bytes = _setup(model, cfg, clients, device, init_params)
    sched = SyncScheduler(
        clients, seed=cfg.seed, dropout_frac=cfg.dropout_frac,
        skip_prob=cfg.periodic_dropout, participation=cfg.participation,
        round_work=cfg.local_epochs * cfg.batch_size,
        upload_bytes=upload_bytes,
    )
    by_id = {c.cid: c for c in sched.active}
    sgd = sgd_epochs(model, cfg, mu=prox_mu)
    enc = _upload_encoder(cfg, dev)
    chaos = _chaos_tools(cfg, clients, dev)
    meter = StalenessMeter()  # the engine's per-arrival stal column
    traj: Dict[int, Dict[str, np.ndarray]] = {}
    sim_time, n_evals, n_uploads = 0.0, 0, 0
    t = 0
    for t in range(1, cfg.T + 1):
        if cfg.sim_time_budget and sim_time > cfg.sim_time_budget:
            break
        arrivals, round_time = sched.next_round(now=sim_time)
        if not arrivals:
            if not np.isfinite(round_time):
                break  # fleet retired: no trace ever rejoins
            sim_time += round_time  # all skipped / whole fleet off-window
            continue
        new_ws, weights = [], []
        for a in arrivals:
            c = by_id[a.cid]
            stal = meter.observe(a.cid, t)
            xs, ys = _batches(c, t, cfg, dev)
            wk = _first(sgd(_one(w), _one(w), xs, ys)[0])
            admit = True
            if enc is not None or chaos is not None:
                # wire delta against the round's broadcast; the engine
                # stamps every participant with the round index t.  The
                # upload is recomposed only where the delta changed
                d = tree_sub(wk, w)
                modified = False
                if enc is not None:
                    d = enc(d, t, a.cid)
                    modified = True
                if chaos is not None:
                    if getattr(a, "corrupt", 0):
                        d = chaos.corrupt(d, a.corrupt, t, a.cid)
                        modified = True
                    admit, sc = chaos.guard(d, stal)
                    if admit and float(sc) < 1.0:
                        d = chaos.scale(d, sc)
                        modified = True
                if modified:
                    wk = tree_map(torch.add, w, d)
            if admit:
                # a duplicated delivery weighs the participant twice
                for _ in range(2 if getattr(a, "dup", False) else 1):
                    new_ws.append(wk)
                    weights.append(c.stream.visible(t))
        n_uploads += len(arrivals)
        sim_time += round_time
        if new_ws:
            tot = sum(weights)
            w = tree_map(
                lambda *xs_: sum(wi / tot * x for wi, x in zip(weights,
                                                                xs_)),
                *new_ws)
        # else: every upload rejected, and finalize keeps the old model
        if collect_trace:
            traj[t] = _host(w)
        if _evaluates(cfg, t):
            n_evals += 1
            _eval_all_per_client(model, w, clients, cfg, dev)
    if stats is not None:
        stats.update(iters=t, ticks=t, evals=n_evals)
        _upload_stats(stats, cfg, upload_bytes, n_uploads, chaos)
    return traj
