"""Federated training entry points: ASO-Fed + every baseline the paper
compares against (FedAvg, FedProx, FedAsync, FedBuff, Local-S, Global).

A thin façade, as ``repro.core.federated``: the event-driven simulation
lives in ``repro_torch.sim`` and each algorithm is a strategy object
under ``repro_torch.core.algorithms``.  ``engine_kwargs`` go to
``run_strategy`` unchanged — among them ``device`` (None: the CUDA card;
``"cpu"`` for the plain-PyTorch path) and ``init_params``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.core.algorithms import STRATEGIES, get_strategy
from repro_torch.sim.engine import HistoryPoint, RunConfig, run_strategy
from repro_torch.sim.profiles import DeviceProfile, SimClient, make_sim_clients

__all__ = [
    "ALGORITHMS",
    "DeviceProfile",
    "HistoryPoint",
    "RunConfig",
    "SimClient",
    "make_sim_clients",
    "run",
    "run_asofed",
    "run_fedavg",
    "run_fedprox",
    "run_fedasync",
    "run_local",
    "run_global",
]


def run(name: str, model, cfg_model, clients, cfg: RunConfig,
        **engine_kwargs) -> List[HistoryPoint]:
    """Run one algorithm through the shared cohort engine."""
    return run_strategy(get_strategy(name), model, cfg_model, clients, cfg,
                        **engine_kwargs)


def _runner(name: str) -> Callable:
    def fn(model, cfg_model, clients, cfg: RunConfig, **kw):
        return run(name, model, cfg_model, clients, cfg, **kw)

    fn.__name__ = f"run_{name}"
    fn.__doc__ = f"``run('{name}', ...)`` through the cohort engine."
    return fn


run_asofed = _runner("asofed")
run_fedavg = _runner("fedavg")
run_fedprox = _runner("fedprox")  # mu defaults to 0.01 in FedProxStrategy
run_fedasync = _runner("fedasync")
run_local = _runner("local")
run_global = _runner("global")

ALGORITHMS: Dict[str, Callable] = {name: _runner(name) for name in STRATEGIES}
