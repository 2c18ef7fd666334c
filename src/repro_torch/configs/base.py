"""Model configuration for the port: the fields the paper's models use.

``ModelConfig`` keeps the JAX package's field names for the paper-scale
LSTM / CNN (``repro.configs.base``); architectures register in ``ARCHS``
by name and ``get_arch`` builds a fresh config.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.registry import Registry

ARCHS: Registry["ModelConfig"] = Registry("architecture")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # lstm | cnn
    citation: str = ""
    in_features: int = 0
    out_features: int = 0
    hidden: int = 0  # LSTM hidden width / CNN conv channels


def get_arch(name: str) -> ModelConfig:
    return ARCHS.get(name)()
