"""Carry the JAX package's parameters across to the port.

``params_from_numpy(tree)`` takes the JAX model's parameters as numpy
arrays (``jax.tree.map(np.asarray, model.init(PRNGKey(seed)))``) and
returns the port's ``dict[str, Tensor]`` in the same layouts, so both
engines can start from the same ``w0``.  Arrays are copied, never
aliased.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_numpy(tree: Mapping[str, np.ndarray], device="cpu"
                      ) -> Dict[str, torch.Tensor]:
    """fp32 copies of the arrays on ``device``, under the same names."""
    out = {}
    for name, arr in tree.items():
        if isinstance(arr, Mapping):
            raise ValueError(
                f"parameter {name!r} is nested; the paper models' "
                "parameters are a flat name -> array mapping")
        out[name] = torch.tensor(np.asarray(arr), dtype=torch.float32,
                                 device=device)
    return out
