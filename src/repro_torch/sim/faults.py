"""Deterministic, rng-free fault injection for the cohort simulators.

The scheduler's determinism contract — chunk-invariance, ``peek_window``
speculation, prefetch, the fused megastep — all rest on the arrival
stream being a pure function of (rng state, heap).  Fault draws therefore
consume **no randomness from the scheduler's generator**: every decision
is a pure hash of ``(fault seed, cid, arrival-stamp bits, channel,
attempt)`` through a splitmix64 mixer, mapped to a uniform in ``[0, 1)``.
Two consequences fall out for free:

* a fault-free run (``FaultSpec`` absent, or every probability 0) replays
  the pre-fault arrival stream **bitwise** — the main rng stream is never
  touched;
* a faulty run keeps every speculation contract bitwise, because the
  draw for an arrival is derivable from the arrival stamp alone, at any
  chunking, on any thread, any number of times.

Channels keep the per-stamp draws independent: loss (per retry attempt),
duplicate delivery, payload corruption, crash-restart, and the backoff
jitter each hash a distinct channel constant, so e.g. raising ``p_loss``
never flips a duplicate decision at the same stamp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

# draw channels (hash-domain separators)
CH_LOSS = 1
CH_DUP = 2
CH_CORRUPT = 3
CH_CRASH = 4
CH_JITTER = 5
CH_RESTART = 6

# Arrival.corrupt wire codes
CORRUPT_NONE = 0
CORRUPT_NAN = 1
CORRUPT_INF = 2
CORRUPT_NOISE = 3

_CORRUPT_CODES = {"nan": CORRUPT_NAN, "inf": CORRUPT_INF,
                  "noise": CORRUPT_NOISE}


def _mix(z: int) -> int:
    """One splitmix64 output step (finalizer of the added golden gamma)."""
    z = (z + _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _stamp_bits(stamp: float) -> int:
    """IEEE-754 bits of the arrival stamp — the exact float64 identity,
    so a draw can never differ between two code paths that agree bitwise
    on the stamp (and must differ when the stamps differ at all)."""
    return int(np.float64(stamp).view(np.uint64))


def hash_uniform(seed: int, cid: int, stamp: float, channel: int,
                 attempt: int = 0) -> float:
    """Deterministic uniform in [0, 1) from the draw's full identity."""
    h = _mix(seed & _MASK64)
    for word in (cid & _MASK64, _stamp_bits(stamp), channel, attempt):
        h = _mix(h ^ word)
    return (h >> 11) * (2.0 ** -53)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-client fault model, replayable from ``(seed, cid, stamp)`` alone.

    Probabilities are per-upload (``p_loss`` additionally per retry
    attempt).  ``corrupt_kind`` selects what a corrupted wire delta looks
    like: ``"nan"`` / ``"inf"`` fill, or ``"noise"`` (large finite
    perturbation — survives a non-finite guard, exercises the norm clip).
    Retries follow exponential backoff with deterministic jitter:
    attempt ``k`` (1-based) redelivers after
    ``backoff_base * backoff_factor**(k-1) * (1 ± backoff_jitter)``
    simulated seconds.  ``restart_penalty`` is the extra delay a crashed
    client pays before its next round completes.
    """

    seed: int = 0
    p_loss: float = 0.0
    p_duplicate: float = 0.0
    p_corrupt: float = 0.0
    p_crash: float = 0.0
    corrupt_kind: str = "nan"
    max_retries: int = 2
    backoff_base: float = 5.0
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.25
    restart_penalty: float = 30.0

    def __post_init__(self):
        if self.corrupt_kind not in _CORRUPT_CODES:
            raise ValueError(
                f"unknown corrupt_kind {self.corrupt_kind!r}: expected one "
                f"of {sorted(_CORRUPT_CODES)}")

    @classmethod
    def uniform(cls, rate: float, *, seed: int = 0,
                corrupt_kind: str = "nan", **kw) -> "FaultSpec":
        """One rate spread across all four fault kinds (the bench axis)."""
        return cls(seed=seed, p_loss=rate, p_duplicate=rate,
                   p_corrupt=rate, p_crash=rate, corrupt_kind=corrupt_kind,
                   **kw)

    @property
    def active(self) -> bool:
        return (self.p_loss > 0.0 or self.p_duplicate > 0.0
                or self.p_corrupt > 0.0 or self.p_crash > 0.0)

    # -- draws (all rng-free) ------------------------------------------

    def lost(self, cid: int, stamp: float, attempt: int) -> bool:
        return hash_uniform(self.seed, cid, stamp, CH_LOSS,
                            attempt) < self.p_loss

    def duplicate(self, cid: int, stamp: float) -> bool:
        return hash_uniform(self.seed, cid, stamp, CH_DUP) < self.p_duplicate

    def crash(self, cid: int, stamp: float) -> bool:
        return hash_uniform(self.seed, cid, stamp, CH_CRASH) < self.p_crash

    def corrupt_code(self, cid: int, stamp: float) -> int:
        if hash_uniform(self.seed, cid, stamp, CH_CORRUPT) < self.p_corrupt:
            return _CORRUPT_CODES[self.corrupt_kind]
        return CORRUPT_NONE

    def retry_delay(self, cid: int, stamp: float, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based) of the upload whose
        original arrival stamp is ``stamp``; strictly positive."""
        u = hash_uniform(self.seed, cid, stamp, CH_JITTER, attempt)
        jitter = 1.0 + self.backoff_jitter * (2.0 * u - 1.0)
        return max(self.backoff_base
                   * (self.backoff_factor ** (attempt - 1)) * jitter, 1e-6)

    def restart_delay(self, cid: int, stamp: float) -> float:
        u = hash_uniform(self.seed, cid, stamp, CH_RESTART)
        jitter = 1.0 + self.backoff_jitter * (2.0 * u - 1.0)
        return max(self.restart_penalty * jitter, 0.0)


def with_faults(clients: Sequence, specs: Sequence[Optional[FaultSpec]]):
    """Clients with ``profile.faults`` attached (shallow copies — streams
    and data arrays are shared), mirroring ``traces.with_traces``."""
    if len(specs) != len(clients):
        raise ValueError(
            f"with_faults: {len(specs)} specs for {len(clients)} clients")
    return [
        dataclasses.replace(
            c, profile=dataclasses.replace(c.profile, faults=fs))
        for c, fs in zip(clients, specs)
    ]
