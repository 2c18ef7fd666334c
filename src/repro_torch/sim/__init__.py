"""Event-driven federated simulation subsystem of the port.

The host layer (scheduler, streams, staging buffers, prefetch, telemetry
log, workloads) is the JAX package's, copied unchanged; the tick and the
engine (``compile``, ``engine``, ``evaluation``) are PyTorch.  See
``repro_torch.sim.engine`` for the contract.
"""
from repro_torch.sim.engine import (
    HistoryPoint,
    RunConfig,
    Strategy,
    run_strategy,
)
from repro_torch.sim.evaluation import Evaluator
from repro_torch.sim.prefetch import (
    PreparedTick,
    TickBuilder,
    TickMeta,
    TickPrefetcher,
    bucket_size,
)
from repro_torch.sim.profiles import (
    DeviceProfile,
    SimClient,
    make_profiles,
    make_sim_clients,
)
from repro_torch.sim.scheduler import Arrival, AsyncScheduler, draw_dropouts
from repro_torch.sim.streaming import OnlineStream
from repro_torch.sim.telemetry import TelemetryLog, TickRecord
from repro_torch.sim.workloads import (
    WORKLOADS,
    Workload,
    get_workload,
    resolve_eval_report,
)

__all__ = [
    "HistoryPoint",
    "RunConfig",
    "Strategy",
    "run_strategy",
    "Evaluator",
    "PreparedTick",
    "TickBuilder",
    "TickMeta",
    "TickPrefetcher",
    "bucket_size",
    "DeviceProfile",
    "SimClient",
    "make_profiles",
    "make_sim_clients",
    "Arrival",
    "AsyncScheduler",
    "draw_dropouts",
    "OnlineStream",
    "TelemetryLog",
    "TickRecord",
    "WORKLOADS",
    "Workload",
    "get_workload",
    "resolve_eval_report",
]
