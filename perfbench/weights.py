"""The weights of a run, drawn by the benchmark on the device from the
seed, into the port's layout, and handed to the port and the reference
alike.

The port's parameter spec gives each leaf's shape and its rule (the
JAX package's: ``normal`` N(0, scale), ``fan_in`` N(0, 1) / sqrt(the
second-to-last axis), ``uniform_scaled`` U(-scale, scale), ``zeros``,
``ones``).  All normal leaves are drawn by one call into one buffer and
all uniform ones by another, in the type the cell runs in, then scaled
in place leaf by leaf; each leaf is a view of its buffer, 256-byte
aligned.  The values are the benchmark's, not the port's own ``init``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 64  # elements: 256 bytes of fp32


def _leaves(spec, prefix=()) -> List[Tuple[Tuple[str, ...], object]]:
    if hasattr(spec, "shape") and hasattr(spec, "init"):
        return [(prefix, spec)]
    out = []
    for k in sorted(spec):
        out += _leaves(spec[k], prefix + (k,))
    return out


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _std(d) -> float:
    if d.init == "normal":
        return d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _buffer(items, dtype, device):
    """One buffer for ``items``' leaves, and each leaf's offset."""
    offs, total = [], 0
    for _, d in items:
        offs.append(total)
        total += -(-math.prod(d.shape) // ALIGN) * ALIGN
    return torch.empty(max(total, 1), dtype=dtype, device=device), offs


def draw(spec, seed: int, dtype: torch.dtype, device,
         cooled: Dict = None) -> Dict:
    """The nested dict of leaves for ``spec``, from ``seed``.  ``cooled``
    (``{"leaves": [names], "scale": s}``) scales every leaf of those
    names by s once drawn."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = _leaves(spec)
    out: Dict = {}
    groups = {"normal": [x for x in leaves if x[1].init in ("normal",
                                                             "fan_in")],
              "uniform": [x for x in leaves
                          if x[1].init == "uniform_scaled"]}
    for kind, items in groups.items():
        if not items:
            continue
        buf, offs = _buffer(items, dtype, device)
        if kind == "normal":
            buf.normal_(generator=gen)
        else:
            buf.uniform_(-1.0, 1.0, generator=gen)
        for (path, d), off in zip(items, offs):
            v = buf[off:off + math.prod(d.shape)].view(d.shape)
            v.mul_(_std(d) if kind == "normal" else d.scale)
            _set(out, path, v)
    for path, d in leaves:
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            _set(out, path, fill(d.shape, dtype=dtype, device=device))
        elif d.init not in ("normal", "fan_in", "uniform_scaled"):
            raise ValueError(f"unknown init {d.init!r} at {'/'.join(path)}")
    if cooled:
        names = set(cooled["leaves"])
        for path, _ in leaves:
            if path[-1] in names:
                leaf = out
                for k in path:
                    leaf = leaf[k]
                leaf.mul_(cooled["scale"])
    return out


def flat(tree, prefix=()) -> Dict[str, torch.Tensor]:
    """``{"a/b/c": leaf}`` in sorted key order."""
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], prefix + (k,)))
    return out
