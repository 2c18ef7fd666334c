"""Event scheduling for the asynchronous cohort simulation engine.

One seeded ``numpy`` Generator drives every stochastic decision — permanent
dropout draws (Fig. 4), periodic skip draws (Fig. 5), and per-round delay
jitter — in a fixed order tied to the event stream, so a given seed yields
an identical arrival order regardless of how the engine chunks events into
ticks (the cohort engine at any ``max_cohort`` replays the exact event
sequence of the per-arrival reference loop).

Availability traces (``repro_torch.sim.traces``) are consulted at **pop time**
and consume no randomness: a completion event popping inside an
off-window is deferred to the next on-window edge (re-queued at that
time), and a one-shot trace with no further on-window retires the client.
Because deferral is a pure function of (heap, trace), the event stream
stays a pure function of (rng state, heap) — tick-chunking invariance and
the ``peek_tick``/``peek_window``/``commit`` speculation contract survive
unchanged.  ``SyncScheduler`` consults traces at round-sampling time
instead: only on-window clients are eligible participants (its own rng
stream once traces are attached — see the class docstring).

Dropout state is **scheduler-local**: the seeded draw selects client
*positions* but marks nothing on the shared ``SimClient`` objects, so an
engine and a reference oracle built from the same client list can never
interfere (pre-existing manual ``SimClient.dropped`` flags are still
honored).

Three schedules:

* ``AsyncScheduler``  — the paper's regime: a priority queue of completion
  events; each pop immediately draws the client's next round delay and
  re-queues it, so the global event order is fixed at pop time.
* ``SyncScheduler``   — FedAvg/FedProx rounds: sample ``C*K`` participants,
  the round costs the *slowest* participant (synchronous barrier).
* ``SweepScheduler``  — Local/Global baselines: every client, every round.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.profiles import SimClient


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One client update reaching the server.

    ``time`` is the simulated arrival instant; ``delay`` the duration of
    the local round that completes at ``time`` (feeds the paper's dynamic
    learning-step multiplier, Eq. 11).

    The fault fields default to the benign values, so fault-free
    construction (and every pre-fault equality pin) is unchanged:
    ``dup`` marks a duplicate delivery the server folds twice;
    ``corrupt`` carries a ``repro_torch.sim.faults.CORRUPT_*`` wire code
    applied to the upload delta inside the jitted tick; ``fresh`` marks
    the client's first arrival after a crash-restart (its local state is
    reset to init before this arrival's round).
    """

    cid: int
    time: float
    delay: float
    dup: bool = False
    corrupt: int = 0
    fresh: bool = False


def draw_dropouts(n: int, frac: float,
                  rng: np.random.Generator) -> FrozenSet[int]:
    """Positions of the ``frac * n`` permanently-dropped clients (Fig. 4).

    One ``rng.choice`` draw, identical to the rng stream every seeded
    run has consumed since dropout draws began; the caller owns the returned set, so two
    schedulers seeded differently over the same client list each get
    their own draw without stepping on each other.
    """
    k = int(n * frac)
    return frozenset(int(i) for i in rng.choice(n, size=k, replace=False))


def _split_active(clients: Sequence[SimClient], frac: float,
                  rng: np.random.Generator
                  ) -> Tuple[List[SimClient], FrozenSet[int]]:
    """(active clients, dropped cids) under a scheduler-local draw."""
    dropped_pos = draw_dropouts(len(clients), frac, rng) if frac \
        else frozenset()
    dropped_cids = frozenset(clients[i].cid for i in dropped_pos)
    active = [c for c in clients
              if not c.dropped and c.cid not in dropped_cids]
    return active, dropped_cids


class AsyncScheduler:
    """Priority-queue completion events with dropout / periodic-skip policies.

    Delay draws happen *at pop time* (a round's duration does not depend on
    its numerical result), which makes the full event stream deterministic
    given the seed — the foundation of tick-equivalence.  Availability
    traces are also resolved at pop time, consuming no randomness: an
    off-window completion is re-queued at the next on-window edge, an
    exhausted one-shot trace retires the client (``deferred`` / ``retired``
    count both, and roll back with the speculation state).

    ``upload_bytes`` meters the client→server upload against each
    device's ``DeviceProfile.bandwidth_bytes_per_s``: every completion
    (including the initial round) costs ``upload_time(upload_bytes)``
    extra simulated seconds.  The cost is a pure per-client constant —
    no rng draw — so the event stream stays a pure function of (rng
    state, heap) and every chunk-invariance / speculation contract
    survives; unmetered profiles (bandwidth ``None``, the default) add
    exactly 0.0 and replay the pre-bandwidth stream bitwise.
    """

    # Hang guard for next_tick: a degenerate config (p_crash/p_loss near
    # 1.0, or skip_prob=1.0) with no sim_time_budget re-queues every event
    # forever and never delivers.  Any realistic config delivers within a
    # few dozen consecutive events (bounded deferral streaks scale with
    # fleet size, hence the per-client term), so the bound is unreachable
    # except when the loop genuinely cannot terminate — then it raises
    # instead of silently spinning.
    _MAX_SPINS = 100_000

    def __init__(self, clients: Sequence[SimClient], *, seed: int = 0,
                 dropout_frac: float = 0.0, skip_prob: float = 0.0,
                 init_work: int = 32, round_work: int = 64,
                 sim_time_budget: Optional[float] = None,
                 upload_bytes: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.active, self.dropped_cids = _split_active(
            clients, dropout_frac, self.rng)
        self.by_id = {c.cid: c for c in self.active}
        self._max_spins = max(self._MAX_SPINS, 100 * len(self.active))
        self.skip_prob = skip_prob
        self.init_work = init_work
        self.round_work = round_work
        self.budget = sim_time_budget
        self.upload_bytes = upload_bytes
        self.deferred = 0  # off-window completions pushed to an on-edge
        self.retired = 0  # clients whose one-shot trace ran out
        # fault counters (all roll back with peek_window speculation)
        self.lost = 0        # uploads dropped with retries exhausted
        self.retried = 0     # retry deliveries scheduled (backoff pushes)
        self.crashed = 0     # crash-restart events (round destroyed)
        self.duplicated = 0  # arrivals delivered with dup=True
        self.corrupted = 0   # arrivals delivered with corrupt != 0
        self._crashed: set = set()  # cids whose next arrival is fresh
        # heap entries: (time, cid) round completions, or
        # (time, cid, 1, (orig_stamp, delay0, attempt)) retry deliveries.
        # Tuple comparison stays total: equal (time, cid) prefixes order
        # the 2-tuple first, and retry payloads are all-float tuples.
        self._heap: List[Tuple] = []
        self._pending: Optional[Tuple] = None
        for c in self.active:
            heapq.heappush(
                self._heap,
                (c.profile.delay(self.rng, init_work)
                 + c.profile.upload_time(upload_bytes), c.cid)
            )

    def _counters(self) -> Tuple:
        """Snapshot of every speculation-sensitive counter (the frozenset
        copy makes the crashed-cid set rollback-safe)."""
        return (self.deferred, self.retired, self.lost, self.retried,
                self.crashed, self.duplicated, self.corrupted,
                frozenset(self._crashed))

    def _restore_counters(self, counters: Tuple) -> None:
        (self.deferred, self.retired, self.lost, self.retried,
         self.crashed, self.duplicated, self.corrupted, crashed) = counters
        self._crashed = set(crashed)

    def state_dict(self) -> dict:
        """JSON-able snapshot of every mutable field (crash-resume hook).

        Captured between a ``commit`` and the next ``peek_window`` — no
        speculation in flight — it pins the exact event stream: the
        pop-time-draw contract makes (rng state, heap, counters, crashed
        set) the scheduler's complete state.
        """
        if self._pending is not None:
            raise RuntimeError(
                "state_dict() with an uncommitted peek in flight")
        return {
            "rng": self.rng.bit_generator.state,
            "heap": [list(e[:3]) + [list(e[3])] if len(e) > 2 else list(e)
                     for e in self._heap],
            "counters": [self.deferred, self.retired, self.lost,
                         self.retried, self.crashed, self.duplicated,
                         self.corrupted],
            "crashed": sorted(self._crashed),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (heap order preserved —
        a copy of a valid heap is a valid heap)."""
        self.rng.bit_generator.state = state["rng"]
        heap: List[Tuple] = []
        for e in state["heap"]:
            if len(e) > 2:  # retry delivery: nested payload tuple
                heap.append((float(e[0]), int(e[1]), int(e[2]),
                             (float(e[3][0]), float(e[3][1]), int(e[3][2]))))
            else:
                heap.append((float(e[0]), int(e[1])))
        self._heap = heap
        (self.deferred, self.retired, self.lost, self.retried, self.crashed,
         self.duplicated, self.corrupted) = (int(v)
                                             for v in state["counters"])
        self._crashed = {int(c) for c in state["crashed"]}
        self._pending = None

    def peek_tick(self, limit: int) -> List[Arrival]:
        """Speculatively compute the next tick without consuming state.

        ``peek_window(1, limit)`` with the tick unwrapped — see
        :meth:`peek_window` for the speculation contract.
        """
        ticks = self.peek_window(1, limit)
        return ticks[0] if ticks else []

    def peek_window(self, n_ticks: int, limit: int,
                    total_limit: Optional[int] = None,
                    count=None) -> List[List[Arrival]]:
        """Speculatively compute up to ``n_ticks`` consecutive ticks.

        Runs the exact ``next_tick`` pop/draw sequence ``n_ticks`` times on
        the live state, records the post-window (rng, heap, counters)
        triple, then rolls everything back — so the lookahead consumes no
        extra randomness and a skipped commit leaves the scheduler
        bit-identical to before the peek.  The pop-time-draw contract makes
        this safe: the event stream is a pure function of (rng state, heap),
        so the recorded outcome is exactly what ``n_ticks`` direct
        ``next_tick`` calls would produce — the foundation of the engine's
        multi-tick window dispatch (one staging block per window)
        and of the prefetch thread that builds the window's staging block
        while the previous window executes on device.

        ``limit`` caps each tick's arrivals (distinct clients per tick);
        ``total_limit``, when given, caps the window's *counted* arrivals,
        where ``count(tick)`` (default ``len``) says how many of a tick's
        arrivals the budget charges.  The engine counts only trainable
        arrivals: its iteration budget advances per fold, so a tick's
        dropped empty-split clients must not shrink the next tick's limit
        — each in-window limit must equal the one a window=1 producer
        would compute, or window size would change tick membership (and
        break the window-on/off bit-identity contract).  The window ends
        early at a drained/over-budget scheduler.  ``commit()`` adopts the
        recorded state; only one speculative window is held at a time — a
        second peek before commit replaces the first (identical by
        determinism).
        """
        rng_state = self.rng.bit_generator.state
        heap = list(self._heap)
        counters = self._counters()
        self._pending = None
        ticks: List[List[Arrival]] = []
        count = count if count is not None else len
        remaining = total_limit if total_limit is not None \
            else n_ticks * limit
        for _ in range(n_ticks):
            if remaining <= 0:
                break
            tick = self.next_tick(min(limit, remaining))
            if not tick:
                break
            ticks.append(tick)
            remaining -= count(tick)
        self._pending = (ticks, self.rng.bit_generator.state, self._heap,
                         self._counters())
        self._heap = heap
        self.rng.bit_generator.state = rng_state
        self._restore_counters(counters)
        return ticks

    def commit(self) -> None:
        """Adopt the state recorded by the last ``peek_tick``."""
        if self._pending is None:
            raise RuntimeError("commit() without a preceding peek_tick()")
        _, rng_state, heap, counters = self._pending
        self.rng.bit_generator.state = rng_state
        self._heap = heap
        self._restore_counters(counters)
        self._pending = None

    def next_tick(self, limit: int) -> List[Arrival]:
        """Pop up to ``limit`` arrivals with pairwise-distinct clients.

        The distinct-client check runs against *every* heap top — including
        tops surfaced mid-tick by a skipped event — and stops *before*
        popping (a repeat client's local round depends on this tick's server
        folds), so no rng draw is consumed out of order and the global event
        stream is identical for every tick size.

        Off-window heap tops are *normalized* first — deferred to their
        trace's next on-edge (or retired when the trace is exhausted) —
        before the budget/seen checks run.  Normalization touches only the
        heap, never the rng, so it commutes across tick boundaries and
        replays identically under ``peek_tick`` rollback.

        Faults run as an rng-free pipeline *after* the fault-free skip and
        delay draws have consumed their exact rng prefix (so the main
        stream is bitwise-identical whether or not faults fire): crash
        first (the round and its upload are destroyed, the client restarts
        after a deterministic penalty), then loss (a lost upload schedules
        a backoff retry-delivery event; the client's next round proceeds
        regardless — uploads are fire-and-forget), then duplicate /
        corruption flags stamped on the delivered arrival.  Retry
        deliveries re-derive every decision from the upload's *original*
        stamp, so an attempt's outcome is chunking-independent.
        """
        self._pending = None  # a direct pop invalidates any speculation
        tick: List[Arrival] = []
        seen = set()
        spins = 0  # consecutive events processed without a delivery
        while len(tick) < limit and self._heap:
            spins += 1
            if spins > self._max_spins:
                raise RuntimeError(
                    f"scheduler processed {self._max_spins} consecutive "
                    "events without delivering an arrival — a degenerate "
                    "config (p_crash/p_loss near 1.0, or skip_prob=1.0) "
                    "with no sim_time_budget can never deliver; bound the "
                    "run with sim_time_budget or lower the fault/skip "
                    "rates")
            top = self._heap[0]
            top_time, top_cid = top[0], top[1]
            is_retry = len(top) > 2
            if self.budget is not None and top_time > self.budget:
                # budget before normalization: deferral only moves times
                # forward, so a raw time past the budget can never yield
                # an in-budget arrival — don't count (or retire) events
                # the budgeted run never reaches
                break
            tr = self.by_id[top_cid].profile.trace
            if tr is not None and not tr.is_on(top_time):
                heapq.heappop(self._heap)
                t_on = tr.next_on(top_time)
                if t_on is None:
                    if is_retry:
                        # the in-flight upload can never land; only the
                        # client's *round* event retires it
                        self.lost += 1
                    else:
                        self.retired += 1  # one-shot trace exhausted:
                    continue               # Fig.-4 permanent departure
                heapq.heappush(self._heap, (t_on,) + tuple(top[1:]))
                if self.budget is not None and t_on > self.budget:
                    # the on-edge lands past the budget: the budgeted run
                    # never delivers this event, so it must not count as
                    # deferred — but re-queue it (above) so in-budget
                    # tops still buried under it keep surfacing
                    continue
                self.deferred += 1  # next_on > top_time strictly when off
                continue
            if top_cid in seen:
                break
            if is_retry:
                # retry delivery: fully rng-free — no skip/delay draws, no
                # round requeue; the loss/backoff draws key on the
                # original stamp + attempt
                heapq.heappop(self._heap)
                now, cid = top[0], top[1]
                orig_stamp, delay0, attempt = top[3]
                fs = self.by_id[cid].profile.faults
                if fs.lost(cid, orig_stamp, attempt):
                    if attempt < fs.max_retries:
                        self.retried += 1
                        heapq.heappush(self._heap, (
                            now + fs.retry_delay(cid, orig_stamp,
                                                 attempt + 1),
                            cid, 1, (orig_stamp, delay0, attempt + 1)))
                    else:
                        self.lost += 1  # retries exhausted: upload gone
                    continue
                tick.append(self._deliver(cid, now, delay0, orig_stamp, fs))
                seen.add(cid)
                spins = 0
                continue
            now, cid = heapq.heappop(self._heap)
            c = self.by_id[cid]
            if self.skip_prob and self.rng.uniform() < self.skip_prob:
                # silent skip (Fig. 5): no global iteration consumed; the
                # client re-queues after a fresh (cheap) delay draw
                heapq.heappush(
                    self._heap,
                    (now + c.profile.delay(self.rng, self.init_work), cid),
                )
                continue
            delay = c.profile.delay(self.rng, self.round_work) \
                + c.profile.upload_time(self.upload_bytes)
            fs = c.profile.faults
            if fs is not None and fs.active:
                if fs.crash(cid, now):
                    # round destroyed, no arrival; the client restarts
                    # from init state after a deterministic penalty and
                    # its next delivered arrival is marked fresh
                    self.crashed += 1
                    self._crashed.add(cid)
                    heapq.heappush(
                        self._heap,
                        (now + fs.restart_delay(cid, now) + delay, cid))
                    continue
                heapq.heappush(self._heap, (now + delay, cid))
                if fs.lost(cid, now, 0):
                    if fs.max_retries > 0:
                        self.retried += 1
                        heapq.heappush(self._heap,
                                       (now + fs.retry_delay(cid, now, 1),
                                        cid, 1, (now, delay, 1)))
                    else:
                        self.lost += 1
                    continue
                tick.append(self._deliver(cid, now, delay, now, fs))
                seen.add(cid)
                spins = 0
                continue
            heapq.heappush(self._heap, (now + delay, cid))
            tick.append(Arrival(cid=cid, time=now, delay=delay))
            seen.add(cid)
            spins = 0
        return tick

    def _deliver(self, cid: int, now: float, delay: float,
                 orig_stamp: float, fs) -> Arrival:
        """Arrival with dup/corrupt decided from the upload's original
        stamp (a retried delivery carries the same flags as attempt 0
        would have) and the post-crash fresh mark consumed."""
        dup = fs.duplicate(cid, orig_stamp)
        corrupt = fs.corrupt_code(cid, orig_stamp)
        fresh = cid in self._crashed
        if fresh:
            self._crashed.discard(cid)
        if dup:
            self.duplicated += 1
        if corrupt:
            self.corrupted += 1
        return Arrival(cid=cid, time=now, delay=delay,
                       dup=dup, corrupt=corrupt, fresh=fresh)


class SyncScheduler:
    """FedAvg/FedProx participant sampling with the synchronous barrier.

    Availability traces restrict the sampling pool: a round starting at
    simulated time ``now`` samples only clients whose trace is on-window
    at ``now`` (FedAvg under structured churn — the server cannot recruit
    a dark device).  Sampled participants hold the barrier for their full
    round even if their window closes mid-round (the barrier waits, as a
    synchronous server must).  When the whole fleet is off-window the
    round is empty and ``round_time`` is the wait until the earliest
    rejoin edge (``inf`` when every one-shot trace is exhausted — the run
    is over).  Traceless fleets are unchanged: the eligible pool equals
    ``active``, so the participant rng stream is bit-identical to the
    pre-trace scheduler; traced fleets draw from a *different* stream
    (the pool size varies), which is why FedAvg-under-churn carries its
    own reference oracle.

    ``upload_bytes`` meters each participant's report against its
    ``bandwidth_bytes_per_s`` exactly as in ``AsyncScheduler`` — a
    deterministic additive cost on the participant's delay, so the
    barrier waits for the slowest *upload-inclusive* round and the
    participant-sampling rng stream is untouched.

    Faults are minimal here (sync participants hold no cross-round local
    state and the barrier admits no late redelivery): crash is treated
    as loss, lost reports simply miss the round — no retries — and
    dup/corrupt flags ride the delivered arrivals.  All draws are
    rng-free hashes of the round's ``now`` stamp, so fault-free sampling
    is bitwise unchanged.
    """

    def __init__(self, clients: Sequence[SimClient], *, seed: int = 0,
                 dropout_frac: float = 0.0, skip_prob: float = 0.0,
                 participation: float = 0.2, round_work: int = 64,
                 upload_bytes: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.active, self.dropped_cids = _split_active(
            clients, dropout_frac, self.rng)
        self.skip_prob = skip_prob
        self.m = max(1, int(participation * len(self.active)))
        self.round_work = round_work
        self.upload_bytes = upload_bytes
        self.lost = 0
        self.retried = 0  # always 0: the barrier admits no redelivery
        self.crashed = 0
        self.duplicated = 0
        self.corrupted = 0

    def next_round(self, now: float = 0.0) -> Tuple[List[Arrival], float]:
        """(participants, round_time).  round_time = slowest participant,
        or the wait to the next on-window edge when nobody is available."""
        eligible = [c for c in self.active
                    if c.profile.trace is None or c.profile.trace.is_on(now)]
        if not eligible:
            rejoin = [c.profile.trace.next_on(now) for c in self.active
                      if c.profile.trace is not None]
            rejoin = [t for t in rejoin if t is not None]
            if not rejoin:  # every one-shot trace exhausted: fleet retired
                return [], math.inf
            return [], min(rejoin) - now
        sel = self.rng.choice(len(eligible), size=min(self.m, len(eligible)),
                              replace=False)
        arrivals: List[Arrival] = []
        for i in sel:
            c = eligible[int(i)]
            if self.skip_prob and self.rng.uniform() < self.skip_prob:
                continue
            delay = c.profile.delay(self.rng, self.round_work) \
                + c.profile.upload_time(self.upload_bytes)
            fs = c.profile.faults
            if fs is not None and fs.active:
                # rng-free, after the fault-free draws consumed their
                # exact prefix; crash == loss for a stateless participant
                if fs.crash(c.cid, now):
                    self.crashed += 1
                    continue
                if fs.lost(c.cid, now, 0):
                    self.lost += 1
                    continue
                dup = fs.duplicate(c.cid, now)
                corrupt = fs.corrupt_code(c.cid, now)
                self.duplicated += int(dup)
                self.corrupted += int(bool(corrupt))
                arrivals.append(Arrival(cid=c.cid, time=now, delay=delay,
                                        dup=dup, corrupt=corrupt))
                continue
            arrivals.append(Arrival(cid=c.cid, time=now, delay=delay))
        round_time = max((a.delay for a in arrivals), default=0.0)
        return arrivals, round_time


class SweepScheduler:
    """Local/Global baselines: every responsive client, every round.

    Honors pre-set ``SimClient.dropped`` flags like every other
    scheduler (a permanently dark device trains no baseline either),
    and stamps arrivals with the round's actual ``now`` so baseline
    histories share the simulated-time axis of the federated runs.
    """

    def __init__(self, clients: Sequence[SimClient]):
        self.active = [c for c in clients if not c.dropped]

    def next_round(self, now: float = 0.0) -> Tuple[List[Arrival], float]:
        return [Arrival(cid=c.cid, time=now, delay=0.0)
                for c in self.active], 1.0
