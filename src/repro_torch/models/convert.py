"""Carry the JAX package's parameters across to the port.

``params_from_numpy(tree)`` takes the JAX model's parameters as numpy
arrays (``jax.tree.map(np.asarray, model.init(PRNGKey(seed)))``): the
paper models' flat name -> array mapping, or the transformer's nested
dicts with stacked per-layer leaves.  It returns the same tree of torch
tensors in the same layouts, so both packages start from the same
weights.  Arrays are copied, never aliased.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def params_from_numpy(tree: Mapping[str, Any], device=None) -> Any:
    """fp32 copies of the arrays on ``device`` (``None``: the CUDA card),
    under the same (nested) names."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {name: walk(sub) for name, sub in node.items()}
        return torch.tensor(np.asarray(node), dtype=torch.float32,
                            device=dev)

    return walk(tree)
