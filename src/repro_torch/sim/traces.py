"""Trace-driven client availability: replayable on/off windows.

The paper's robustness claims (Fig. 4/5) cover permanent dropout and
i.i.d. skips; real edge fleets additionally show *structured* churn —
diurnal duty cycles, correlated straggler bursts, flash-crowd rejoins —
which resource-aware follow-ups treat as first-class.  This module makes
availability a replayable per-client **trace** instead of a coin flip:

* :class:`AvailabilityTrace` — sorted disjoint half-open on-windows
  ``[start, end)`` in simulated seconds, optionally repeated with a
  ``period`` (diurnal cycles) or one-shot (a device log).  Pure data +
  pure queries (``is_on`` / ``next_on`` / ``on_seconds``): consulting a
  trace never draws randomness, which is what lets the scheduler defer
  off-window completions at pop time without breaking the
  pop-time-draw determinism contract (tick-equivalence, peek/commit
  speculation, prefetch bit-identity all survive unchanged).
* Seeded scenario generators — :func:`markov_churn`, :func:`diurnal`,
  :func:`straggler_waves`, :func:`flash_crowd` — each returning one
  trace per client, plus :func:`scenario_traces` to build them by name
  (``"diurnal"``, ``"bursty"``, ``"churn"``, ``"flash"``,
  ``"trace:<path>"``).
* JSONL persistence (:func:`save_jsonl` / :func:`load_jsonl`) so real
  device logs can be replayed: one ``{"cid", "period", "windows"}``
  object per line, ``null`` window end = open-ended, ``null`` period =
  one-shot.

Scheduler semantics (see ``repro_torch.sim.scheduler``): a completion event
popping inside an off-window is *deferred* to the next on-window edge
(no rng draw consumed); a one-shot trace with no further on-window
retires the client permanently — the trace-driven generalization of
Fig. 4 dropout.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Window = Tuple[float, float]

INF = math.inf


@dataclasses.dataclass(frozen=True)
class AvailabilityTrace:
    """Replayable on/off availability of one client.

    ``windows`` are sorted, disjoint, half-open on-intervals
    ``[start, end)`` with ``0 <= start < end``.  With ``period`` set the
    pattern repeats forever (every window must fit in ``[0, period)``);
    with ``period=None`` the trace is one-shot — the device is off
    before the first window, between windows, and permanently off after
    the last window ends (an open-ended last window, ``end=inf``, keeps
    it on forever).  An empty one-shot ``windows`` means never on.
    """

    windows: Tuple[Window, ...]
    period: Optional[float] = None

    def __post_init__(self):
        prev_end = 0.0
        for s, e in self.windows:
            if not (0.0 <= s < e):
                raise ValueError(f"bad window [{s}, {e})")
            if s < prev_end:
                raise ValueError("windows must be sorted and disjoint")
            prev_end = e
        if self.period is not None:
            if not (self.period > 0.0 and math.isfinite(self.period)):
                raise ValueError(f"bad period {self.period}")
            if self.windows and self.windows[-1][1] > self.period:
                raise ValueError("cyclic windows must fit in [0, period)")
        # bisect keys (plain tuples: the dataclass stays hashable)
        object.__setattr__(self, "_ends", tuple(e for _, e in self.windows))
        object.__setattr__(
            self, "_on_per_period",
            sum(e - s for s, e in self.windows) if self.period else 0.0,
        )

    # -- queries (pure: no randomness, no mutation) ----------------------

    def _local(self, t: float) -> float:
        return t % self.period if self.period is not None else t

    def is_on(self, t: float) -> bool:
        """Whether the device is available at simulated time ``t``."""
        tau = self._local(max(t, 0.0))
        i = bisect.bisect_right(self._ends, tau)
        return i < len(self.windows) and self.windows[i][0] <= tau

    def next_on(self, t: float) -> Optional[float]:
        """Smallest ``t' >= t`` with ``is_on(t')``; None if never again.

        Strictly greater than ``t`` whenever ``is_on(t)`` is false (the
        scheduler's deferral-loop termination guarantee).
        """
        t = max(t, 0.0)
        tau = self._local(t)
        i = bisect.bisect_right(self._ends, tau)
        if i < len(self.windows):
            s = self.windows[i][0]
            if s <= tau:
                return t  # already inside an on-window
            cand = t + (s - tau)
        elif self.period is None or not self.windows:
            return None  # one-shot trace exhausted (or never on)
        else:
            cand = t + (self.period - tau) + self.windows[0][0]
        # fp guards for the deferral contract (cand > t and is_on(cand)):
        # adding a sub-ulp gap to a large t rounds back to exactly t, and
        # re-reducing cand mod period can land an ulp short of the window
        # start.  Nudge forward — windows are vastly wider than an ulp, so
        # this terminates in a handful of steps.
        while cand <= t or not self.is_on(cand):
            cand = math.nextafter(cand, INF)
        return cand

    def on_seconds(self, t0: float, t1: float) -> float:
        """Integrated on-time over ``[t0, t1)``."""
        return self._cum(max(t1, 0.0)) - self._cum(max(t0, 0.0))

    def _cum(self, t: float) -> float:
        if self.period is not None:
            n_full, tau = divmod(t, self.period)
            return n_full * self._on_per_period + self._partial(tau)
        return self._partial(t)

    def _partial(self, t: float) -> float:
        acc = 0.0
        for s, e in self.windows:
            if s >= t:
                break
            acc += min(e, t) - s
        return acc

    def on_fraction(self, t0: float, t1: float) -> float:
        """Availability utilization over ``[t0, t1)`` (1.0 if t1 <= t0)."""
        if t1 <= t0:
            return 1.0
        return self.on_seconds(t0, t1) / (t1 - t0)

    # -- (de)serialization ----------------------------------------------

    def to_json(self, cid: Optional[int] = None) -> Dict:
        d: Dict = {
            "period": self.period,
            "windows": [[s, None if math.isinf(e) else e]
                        for s, e in self.windows],
        }
        if cid is not None:
            d["cid"] = cid
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "AvailabilityTrace":
        return cls(
            windows=tuple((float(s), INF if e is None else float(e))
                          for s, e in d["windows"]),
            period=None if d.get("period") is None else float(d["period"]),
        )


ALWAYS_ON = AvailabilityTrace(windows=((0.0, INF),))


def save_jsonl(path: str, traces: Sequence[Optional[AvailabilityTrace]]
               ) -> None:
    """One ``{"cid", "period", "windows"}`` object per line, cid = index.

    ``None`` entries (always-on clients) are written as ``ALWAYS_ON``.
    """
    with open(path, "w") as f:
        for cid, tr in enumerate(traces):
            f.write(json.dumps((tr or ALWAYS_ON).to_json(cid=cid)) + "\n")


def load_jsonl(path: str) -> Dict[int, AvailabilityTrace]:
    """{cid: trace} from a JSONL device log (blank lines ignored)."""
    out: Dict[int, AvailabilityTrace] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out[int(d["cid"])] = AvailabilityTrace.from_json(d)
    return out


# ---------------------------------------------------------------------------
# Seeded scenario generators: one trace per client, reproducible by seed
# ---------------------------------------------------------------------------


def markov_churn(n: int, *, seed: int = 0, mean_on: float = 240.0,
                 mean_off: float = 60.0, period: float = 3600.0
                 ) -> List[AvailabilityTrace]:
    """Two-state Markov on/off churn: exponential dwell times, cyclic.

    Each client alternates Exp(``mean_on``) available / Exp(``mean_off``)
    unavailable phases, independently seeded, wrapped at ``period`` so
    long runs never exhaust the trace.
    """
    rng = np.random.default_rng(seed)
    traces = []
    for _ in range(n):
        on = rng.uniform() < mean_on / (mean_on + mean_off)
        t, wins = 0.0, []
        while t < period:
            dwell = float(rng.exponential(mean_on if on else mean_off))
            dwell = max(dwell, 1e-3)  # zero-length windows are invalid
            if on:
                wins.append((t, min(t + dwell, period)))
            t += dwell
            on = not on
        traces.append(AvailabilityTrace(windows=tuple(wins), period=period))
    return traces


def diurnal(n: int, *, seed: int = 0, period: float = 600.0,
            duty: float = 0.6, jitter: float = 0.1
            ) -> List[AvailabilityTrace]:
    """Diurnal duty cycles: on for ~``duty`` of every ``period``, with a
    random per-client phase and ±``jitter`` duty variation (a fleet whose
    devices charge/idle at different local times)."""
    rng = np.random.default_rng(seed)
    traces = []
    for _ in range(n):
        d = duty * (1.0 + float(rng.uniform(-jitter, jitter)))
        on_len = min(max(d, 0.05), 0.95) * period
        phase = float(rng.uniform(0.0, period))
        end = phase + on_len
        if end <= period:
            wins: Tuple[Window, ...] = ((phase, end),)
        else:  # the on-window wraps the period boundary
            wins = ((0.0, end - period), (phase, period))
        traces.append(AvailabilityTrace(windows=wins, period=period))
    return traces


def straggler_waves(n: int, *, seed: int = 0, period: float = 300.0,
                    width: float = 60.0, frac: float = 0.3,
                    jitter: float = 10.0) -> List[AvailabilityTrace]:
    """Correlated straggler bursts: a ``frac`` subset of the fleet goes
    dark for ``width`` seconds once per ``period``, nearly in phase
    (per-client offset jitter), modeling shared-bottleneck waves.
    Unaffected clients are always on."""
    if width + jitter >= period:
        # rng.uniform silently accepts low > high, which would yield
        # negative phases and off-windows narrower than requested
        raise ValueError(
            f"width + jitter ({width} + {jitter}) must be < period "
            f"({period}) so the burst fits inside one cycle")
    rng = np.random.default_rng(seed)
    base = float(rng.uniform(0.0, period - width - jitter))
    riders = set(int(i) for i in rng.choice(
        n, size=int(n * frac), replace=False)) if frac > 0 and n else set()
    traces = []
    for i in range(n):
        if i not in riders:
            traces.append(ALWAYS_ON)
            continue
        off0 = base + float(rng.uniform(0.0, jitter))
        off1 = min(off0 + width, period)
        wins: List[Window] = []
        if off0 > 0.0:
            wins.append((0.0, off0))
        if off1 < period:
            wins.append((off1, period))
        traces.append(AvailabilityTrace(windows=tuple(wins), period=period))
    return traces


def flash_crowd(n: int, *, seed: int = 0, t_join: float = 200.0,
                stagger: float = 60.0) -> List[AvailabilityTrace]:
    """Flash-crowd rejoin: every client is dark until a staggered join
    time near ``t_join``, then permanently available (a fleet coming
    online after an outage or a coordinated enrollment)."""
    rng = np.random.default_rng(seed)
    return [
        AvailabilityTrace(
            windows=((t_join + float(rng.uniform(0.0, stagger)), INF),)
        )
        for _ in range(n)
    ]


_GENERATORS = {
    "churn": markov_churn,
    "markov": markov_churn,
    "diurnal": diurnal,
    "bursty": straggler_waves,
    "straggler": straggler_waves,
    "flash": flash_crowd,
}


def scenario_traces(name: Optional[str], n: int, *, seed: int = 0,
                    **kw) -> List[Optional[AvailabilityTrace]]:
    """Build ``n`` per-client traces for a named scenario.

    ``None`` / ``"always_on"`` return ``[None] * n`` (no trace overhead);
    ``"trace:<path>"`` replays a JSONL device log (clients missing from
    the log are always-on); other names dispatch to the generators.
    """
    if name is None or name == "always_on":
        return [None] * n
    if name.startswith("trace:"):
        by_cid = load_jsonl(name[len("trace:"):])
        return [by_cid.get(i) for i in range(n)]
    gen = _GENERATORS.get(name)
    if gen is None:
        raise ValueError(
            f"unknown availability scenario {name!r}; "
            f"expected one of {sorted(_GENERATORS)}, 'always_on', "
            "or 'trace:<path>'"
        )
    return gen(n, seed=seed, **kw)


# ---------------------------------------------------------------------------
# Attachment + fleet-level stats
# ---------------------------------------------------------------------------


def with_traces(clients: Sequence, traces: Sequence[Optional[
        AvailabilityTrace]]) -> List:
    """A new client list with ``traces[i]`` attached to client i's profile.

    ``None`` entries stay always-on.  The input clients are not mutated —
    traced entries are shallow ``dataclasses.replace`` copies — so a
    client list shared with e.g. a reference oracle keeps its original
    profiles.  (The copies still share the stateful ``stream`` objects
    with the originals, as SimClient copies always do: build fresh
    clients per run when stream rng isolation matters.)
    """
    clients = list(clients)
    if len(traces) < len(clients):
        raise ValueError(
            f"{len(traces)} traces for {len(clients)} clients")
    return [
        c if tr is None else dataclasses.replace(
            c, profile=dataclasses.replace(c.profile, trace=tr))
        for c, tr in zip(clients, traces)
    ]


def utilization(clients: Sequence, sim_time: float) -> float:
    """Mean availability over ``[0, sim_time)`` across ``clients``
    (traceless clients count as fully available; 1.0 for an empty fleet
    or a zero horizon)."""
    if sim_time <= 0.0 or not clients:
        return 1.0
    fr = [c.profile.trace.on_fraction(0.0, sim_time)
          if c.profile.trace is not None else 1.0 for c in clients]
    return float(sum(fr) / len(fr))
