"""Algorithm strategy objects for the port's cohort engine.

Each strategy supplies only the local-update and aggregation rules of one
algorithm; the shared scheduling / eval / history plumbing lives in
``repro_torch.sim.engine``.  The same seven as ``repro.core.algorithms``.
"""
from __future__ import annotations

from typing import Dict, Type

from repro_torch.core.algorithms.asofed import AsoFedStrategy
from repro_torch.core.algorithms.common import ClientStateCodec
from repro_torch.core.algorithms.fedasync import FedAsyncStrategy
from repro_torch.core.algorithms.fedavg import FedAvgStrategy, FedProxStrategy
from repro_torch.core.algorithms.fedbuff import FedBuffStrategy
from repro_torch.core.algorithms.local_global import (GlobalStrategy,
                                                      LocalStrategy)
from repro_torch.sim.engine import Strategy

STRATEGIES: Dict[str, Type[Strategy]] = {
    "asofed": AsoFedStrategy,
    "fedavg": FedAvgStrategy,
    "fedprox": FedProxStrategy,
    "fedasync": FedAsyncStrategy,
    "fedbuff": FedBuffStrategy,
    "local": LocalStrategy,
    "global": GlobalStrategy,
}


def get_strategy(name: str) -> Strategy:
    """A fresh strategy object; raises ``KeyError`` for an unknown name."""
    if name not in STRATEGIES:
        raise KeyError(
            f"unknown strategy {name!r}; the port has {sorted(STRATEGIES)}")
    return STRATEGIES[name]()


__all__ = ["Strategy", "STRATEGIES", "get_strategy", "ClientStateCodec",
           "AsoFedStrategy", "FedAvgStrategy", "FedProxStrategy",
           "FedAsyncStrategy", "FedBuffStrategy", "LocalStrategy",
           "GlobalStrategy"]
