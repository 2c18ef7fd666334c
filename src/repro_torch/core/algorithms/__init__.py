"""Algorithm strategy objects for the port's cohort engine.

The port carries ASO-Fed, FedAsync, FedBuff, FedAvg and FedProx; the
Local / Global sweep baselines of ``repro.core.algorithms`` are still to
port.
"""
from __future__ import annotations

from typing import Dict, Type

from repro_torch.core.algorithms.asofed import AsoFedStrategy
from repro_torch.core.algorithms.fedasync import FedAsyncStrategy
from repro_torch.core.algorithms.fedavg import FedAvgStrategy, FedProxStrategy
from repro_torch.core.algorithms.fedbuff import FedBuffStrategy
from repro_torch.sim.engine import Strategy

STRATEGIES: Dict[str, Type[Strategy]] = {
    "asofed": AsoFedStrategy,
    "fedasync": FedAsyncStrategy,
    "fedbuff": FedBuffStrategy,
    "fedavg": FedAvgStrategy,
    "fedprox": FedProxStrategy,
}


def get_strategy(name: str) -> Strategy:
    if name not in STRATEGIES:
        raise KeyError(
            f"strategy {name!r} is not ported yet; the port has "
            f"{sorted(STRATEGIES)}")
    return STRATEGIES[name]()


__all__ = ["Strategy", "STRATEGIES", "get_strategy", "AsoFedStrategy",
           "FedAsyncStrategy", "FedBuffStrategy", "FedAvgStrategy",
           "FedProxStrategy"]
