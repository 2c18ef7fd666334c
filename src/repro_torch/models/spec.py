"""Parameter specs for the transformer trunk.

Model code declares its parameters once, as a nested ``dict`` of
``ParamDef`` leaves (shape + initializer), as ``repro.models.spec`` does;
``init_params`` materializes it.  Logical sharding axes are not carried:
the port runs on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.common.device import resolve_device

Spec = Any  # ParamDef | Dict[str, Spec]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | fan_in | uniform_scaled
    scale: float = 0.02


def stack_spec(spec: Spec, n: int) -> Spec:
    """Prepend a stacked layer axis of size ``n`` to every ParamDef."""
    if isinstance(spec, ParamDef):
        return ParamDef((n,) + spec.shape, spec.init, spec.scale)
    return {k: stack_spec(v, n) for k, v in spec.items()}


# a leaf whose fp32 draw would take more bytes than this is drawn one
# matrix (its last two axes) at a time into the leaf in its own dtype:
# Kimi-K2's stacked expert leaves, (1, 384, 7168, 2048), are 22.5 GB in
# fp32 beside ~40 GB of bf16 weights, DeepSeek-V2-Lite's 19.2 GB
SLICE_DRAW_BYTES = 16 * 2 ** 30


def _init_leaf(d: ParamDef, generator: torch.Generator,
               dtype: torch.dtype) -> torch.Tensor:
    gdev = generator.device
    if (d.init in ("normal", "fan_in") and len(d.shape) > 2
            and 4 * math.prod(d.shape) > SLICE_DRAW_BYTES):
        out = torch.empty(d.shape, dtype=dtype, device=gdev)
        mat = ParamDef(d.shape[-2:], d.init, d.scale)  # the same fan-in
        for m in out.view(-1, *d.shape[-2:]):
            m.copy_(_init_leaf(mat, generator, dtype))
        return out
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=gdev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=gdev)
    if d.init == "uniform_scaled":
        v = torch.empty(d.shape, dtype=torch.float32, device=gdev)
        return v.uniform_(-d.scale, d.scale, generator=generator).to(dtype)
    if d.init == "normal":
        std = d.scale
    elif d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    v = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=gdev)
    # scaled in place: Falcon-Mamba's stacked (64, 4096, 8192) in-projections
    # are 8.6 GB in fp32, and a second fp32 temporary would double that
    return v.mul_(std).to(dtype)


def init_params(spec: Spec, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None
                ) -> Dict[str, Any]:
    """Materialize a spec tree with the JAX package's rules
    (``repro/models/spec.py``): ``normal`` is N(0, scale), ``fan_in`` is
    N(0, 1) / sqrt(shape[-2]) (shape[-1] for vectors), ``uniform_scaled``
    is U(-scale, scale), ``zeros`` / ``ones`` are constant.  Leaves are
    drawn in sorted key order (the order ``jax.tree`` flattens in), one
    matrix at a time for a leaf past ``SLICE_DRAW_BYTES`` in fp32, from
    ``generator`` on the generator's own device, then moved to ``device``
    (``None``: the CUDA card), so one seed on one generator device gives
    the same weights on every device.
    The values differ from ``jax.random``'s; to start from the JAX
    package's weights use ``repro_torch.models.convert.params_from_numpy``.
    """
    dev = resolve_device(device)

    def walk(s):
        if isinstance(s, ParamDef):
            return _init_leaf(s, generator, dtype).to(dev)
        return {k: walk(s[k]) for k in sorted(s)}

    return walk(spec)

