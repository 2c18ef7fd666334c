"""Device heterogeneity profiles for the cohort simulation engine.

The paper models edge heterogeneity as a per-client network offset drawn
from U[10, 100] seconds plus a compute model (samples / simulated second).
``DeviceProfile`` packages those knobs (previously ad-hoc ``base_delay`` /
``compute_rate`` fields on ``SimClient``) together with the delay-jitter
distribution, so schedulers draw round delays through one seeded API and
trace-driven availability can slot in later without touching the engine.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.faults import FaultSpec
from repro_torch.sim.streaming import OnlineStream
from repro_torch.sim.traces import AvailabilityTrace

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Compute + network model of one edge device.

    ``delay(rng, n_work)`` is the simulated duration of a round processing
    ``n_work`` samples: deterministic compute time plus the network offset
    scaled by a uniform jitter draw (the paper's 10-100 s random delay).

    ``trace``, when set, is the device's replayable availability: the
    async scheduler defers any completion landing in an off-window to the
    next on-window edge (``repro_torch.sim.traces``).  ``None`` = always on.

    ``bandwidth_bytes_per_s``, when set, meters the device's upload
    link: schedulers add ``upload_time(upload_bytes)`` — a deterministic
    per-client constant, no rng draw — to every round delay, so
    compressed uploads (``RunConfig.upload_codec``) feed *simulated
    arrival times*.  ``None`` (the default) is the unmetered
    behavior: upload cost 0.0, delay draws bitwise unchanged.

    ``faults``, when set, is the device's deterministic fault model
    (``repro_torch.sim.faults.FaultSpec``): upload loss + retry/backoff,
    duplicate delivery, payload corruption, crash-restart — all drawn
    rng-free from the arrival stamp at pop time, so ``None`` (the
    default) replays the fault-free stream bitwise.
    """

    base_delay: float  # mean network offset, seconds (paper: U[10, 100])
    compute_rate: float = 2000.0  # samples / simulated second
    jitter: Tuple[float, float] = (0.8, 1.2)  # multiplicative network jitter
    trace: Optional[AvailabilityTrace] = None  # replayable on/off windows
    bandwidth_bytes_per_s: Optional[float] = None  # upload link (None: free)
    faults: Optional[FaultSpec] = None  # deterministic chaos (None: benign)

    def delay(self, rng: np.random.Generator, n_work: int) -> float:
        compute = n_work / self.compute_rate
        network = self.base_delay * float(rng.uniform(*self.jitter))
        return compute + network

    def upload_time(self, nbytes: float) -> float:
        """Simulated seconds to push ``nbytes`` through the upload link
        — 0.0 when unmetered, and rng-free always (the scheduler adds it
        on top of the pop-time delay draw without perturbing the
        stream)."""
        if self.bandwidth_bytes_per_s is None or nbytes <= 0.0:
            return 0.0
        return float(nbytes) / float(self.bandwidth_bytes_per_s)


def make_profiles(
    n: int,
    *,
    seed: int = 0,
    delay_range: Tuple[float, float] = (10.0, 100.0),
    compute_rate: float = 2000.0,
    bandwidth_range: Optional[Tuple[float, float]] = None,
) -> List[DeviceProfile]:
    """n independent profiles with network offsets drawn from delay_range.

    ``bandwidth_range``, when given, additionally draws each client's
    upload-link ``bandwidth_bytes_per_s`` from U[bandwidth_range] —
    interleaved *after* that client's offset draw, so a ``None`` range
    (the default) leaves the offset rng stream bitwise unchanged.
    """
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = float(rng.uniform(*delay_range))
        bw = (float(rng.uniform(*bandwidth_range))
              if bandwidth_range is not None else None)
        out.append(DeviceProfile(base_delay=base, compute_rate=compute_rate,
                                 bandwidth_bytes_per_s=bw))
    return out


@dataclasses.dataclass
class SimClient:
    """One simulated edge client: its online data stream, held-out test
    split, and device profile.  ``dropped`` marks Fig.-4 permanent
    non-responsiveness (set by the scheduler's dropout policy)."""

    cid: int
    stream: OnlineStream
    test_x: Array
    test_y: Array
    profile: DeviceProfile
    dropped: bool = False

    # -- backcompat shims for the pre-profile field layout ---------------
    @property
    def base_delay(self) -> float:
        return self.profile.base_delay

    @property
    def compute_rate(self) -> float:
        return self.profile.compute_rate


def make_sim_clients(
    datasets: Sequence[Tuple[Array, Array, Array, Array]],
    *,
    seed: int = 0,
    delay_range: Tuple[float, float] = (10.0, 100.0),
    start_frac: float = 0.3,
    growth: float = 0.00075,
    profiles: Optional[Sequence[DeviceProfile]] = None,
    traces: Optional[Sequence[Optional[AvailabilityTrace]]] = None,
    bandwidth_range: Optional[Tuple[float, float]] = None,
    fault_rate: Optional[float] = None,
    fault_seed: int = 0,
    fault_kind: str = "nan",
) -> List[SimClient]:
    """Build SimClients from (train_x, train_y, test_x, test_y) splits.

    Matches the seed reproduction's rng layout: client i's profile offset is
    the i-th U[delay_range] draw from ``default_rng(seed)`` and its stream is
    seeded ``seed + i``.  ``traces[i]``, when given, becomes client i's
    availability trace (``None`` entries stay always-on) — the profile
    delay draws are unaffected, so attaching traces never perturbs the
    delay rng stream.  ``bandwidth_range``, when given, draws client i's
    upload-link bytes/s right after its offset (same interleaving as
    ``make_profiles``): a ``None`` range keeps the offset stream bitwise.

    ``fault_rate``, when given, attaches ``FaultSpec.uniform(fault_rate,
    seed=fault_seed, corrupt_kind=fault_kind)`` to every client.  Fault
    draws are hash-derived from ``(fault_seed, cid, stamp)`` — never from
    this rng — so a ``None`` rate (the default) and every rng stream are
    bitwise unchanged.

    ``profiles``/``traces`` must supply exactly one entry per dataset —
    a short list raises up front instead of mis-indexing mid-build.
    """
    if profiles is not None and len(profiles) != len(datasets):
        raise ValueError(
            f"profiles has {len(profiles)} entries for {len(datasets)} "
            "datasets; pass exactly one DeviceProfile per client")
    if traces is not None and len(traces) != len(datasets):
        raise ValueError(
            f"traces has {len(traces)} entries for {len(datasets)} "
            "datasets; pass exactly one AvailabilityTrace (or None) per "
            "client")
    if profiles is not None and bandwidth_range is not None:
        raise ValueError(
            "bandwidth_range only applies to generated profiles; set "
            "bandwidth_bytes_per_s on the DeviceProfiles you pass instead")
    rng = np.random.default_rng(seed)
    out = []
    for i, (xtr, ytr, xte, yte) in enumerate(datasets):
        if profiles is not None:
            prof = profiles[i]
        else:
            base = float(rng.uniform(*delay_range))
            bw = (float(rng.uniform(*bandwidth_range))
                  if bandwidth_range is not None else None)
            prof = DeviceProfile(base_delay=base, bandwidth_bytes_per_s=bw)
        if traces is not None and traces[i] is not None:
            prof = dataclasses.replace(prof, trace=traces[i])
        if fault_rate:
            prof = dataclasses.replace(
                prof, faults=FaultSpec.uniform(fault_rate, seed=fault_seed,
                                               corrupt_kind=fault_kind))
        out.append(
            SimClient(
                cid=i,
                stream=OnlineStream(
                    xtr, ytr, start_frac=start_frac, growth=growth, seed=seed + i
                ),
                test_x=xte,
                test_y=yte,
                profile=prof,
            )
        )
    return out
