"""Model facade for the paper-scale families (``lstm`` and ``cnn``).

Mirrors ``repro.models.model.Model``: ``init`` / ``loss`` / ``predict``
over plain ``dict[str, Tensor]`` parameters in the JAX layouts.  ``loss``
and ``predict`` accept single or client-stacked parameters (see
``paper_nets``); a stacked loss is one value per client.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import paper_nets as pn


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    spec: pn.Spec

    def init(self, generator: torch.Generator, device="cpu"
             ) -> Dict[str, torch.Tensor]:
        """Draw parameters with the JAX package's rule (``models/spec.py``):
        ``fan_in`` leaves are N(0, 1) / sqrt(shape[-2]) (shape[-1] for
        vectors), ``zeros`` leaves are zero.  Leaves are drawn in sorted
        key order from ``generator`` on the CPU, then moved to ``device``,
        so one seed gives the same weights on every device.  (The values
        differ from ``jax.random``'s; to start from the JAX package's
        weights use ``repro_torch.models.convert.params_from_numpy``.)"""
        out = {}
        for name in sorted(self.spec):
            shape, init = self.spec[name]
            if init == "zeros":
                v = torch.zeros(shape, dtype=torch.float32)
            elif init == "fan_in":
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                v = torch.randn(shape, generator=generator,
                                dtype=torch.float32) / math.sqrt(
                                    max(fan_in, 1))
            else:
                raise ValueError(f"unknown init {init!r}")
            out[name] = v.to(device)
        return out

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        pred = self.predict(params, batch)
        task = batch.get("task", "regression")
        if self.cfg.family == "cnn" or task == "classification":
            l = pn.classification_loss(pred, batch["y"])
        elif task == "multilabel":
            l = pn.multilabel_loss(pred, batch["y"])
        else:
            l = pn.regression_loss(pred, batch["y"])
        return l, {"loss": l}

    def predict(self, params, batch) -> torch.Tensor:
        if self.cfg.family == "lstm":
            return pn.lstm_forward(params, batch["x"])
        if self.cfg.family == "cnn":
            return pn.cnn_forward(params, batch["x"])
        raise ValueError(f"unsupported model family {self.cfg.family!r}")


def build_spec(cfg: ModelConfig) -> pn.Spec:
    if cfg.family == "lstm":
        return pn.lstm_spec(cfg)
    if cfg.family == "cnn":
        return pn.cnn_spec(cfg)
    raise ValueError(
        f"the port builds the paper's lstm / cnn families only; "
        f"{cfg.name!r} is {cfg.family!r}")


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, spec=build_spec(cfg))
