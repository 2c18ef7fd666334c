"""Checkpoints of torch trees in the JAX package's format.

A checkpoint directory holds ``params.npz`` (one ``arr_{i}`` per leaf, in
flatten order) and ``manifest.json`` (``step``, ``keys``, ``dtypes``,
``extra``), exactly as ``repro.checkpoint.checkpoint`` writes them, so a
directory written by either package loads in the other.  Keys are the
``"/"``-joined path entries of
:func:`repro_torch.common.pytree.tree_flatten_with_path`.

numpy has no bfloat16, so a ``torch.bfloat16`` leaf is written as its
int16 bit pattern under the manifest dtype ``"bfloat16"``.  The JAX
package writes such a leaf as raw ``|V2`` bytes under the same name; on
load either form is viewed back to ``torch.bfloat16`` bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.common.pytree import (tree_flatten_with_path,
                                       tree_unflatten)


def _flatten(tree):
    flat = tree_flatten_with_path(tree)
    return ["/".join(path) for path, _ in flat], [v for _, v in flat]


def _to_numpy(v) -> np.ndarray:
    """A leaf as numpy for ``np.savez``: bf16 as its int16 patterns."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.view(torch.int16)
        return v.cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, params, step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Write ``params`` (a tree of tensors or numpy arrays) to ``path``."""
    os.makedirs(path, exist_ok=True)
    keys, vals = _flatten(params)
    arrays = [_to_numpy(v) for v in vals]
    np.savez(os.path.join(path, "params.npz"),
             **{f"arr_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "keys": keys,
        "dtypes": ["bfloat16" if isinstance(v, torch.Tensor)
                   and v.dtype == torch.bfloat16 else str(a.dtype)
                   for v, a in zip(vals, arrays)],
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def _to_tensor(v: np.ndarray, dtype_name: str, like, device) -> torch.Tensor:
    v = np.require(v, requirements="C")  # keeps 0-d leaves 0-d
    if dtype_name == "bfloat16":
        # |V2 (JAX's ml_dtypes leaf) or int16 (this package's): the bits
        t = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(v)
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device, copy=True)


def load_checkpoint(path: str, like, device=None):
    """``(tree, step)``: the checkpoint at ``path`` in the structure of
    ``like``, each leaf on ``device`` (None: the device of ``like``'s
    leaf, the CPU for a numpy leaf).  A key or order mismatch and a
    truncated ``params.npz`` raise ``ValueError`` with the JAX package's
    messages."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys, like_leaves = _flatten(like)
    saved_keys = manifest["keys"]
    if keys != saved_keys:
        # a symmetric set-diff is empty when the two key lists hold the
        # same names in a different order: report each side explicitly
        missing = [k for k in saved_keys if k not in keys]
        unexpected = [k for k in keys if k not in saved_keys]
        if missing or unexpected:
            raise ValueError(
                f"checkpoint structure mismatch at {path!r}: saved keys "
                f"not in target {missing}; target keys not in checkpoint "
                f"{unexpected}")
        raise ValueError(
            f"checkpoint structure mismatch at {path!r}: same keys, "
            f"different order (saved {saved_keys}, target {keys})")
    with np.load(os.path.join(path, "params.npz")) as data:
        if len(data.files) != len(saved_keys):
            raise ValueError(
                f"corrupt checkpoint at {path!r}: manifest lists "
                f"{len(saved_keys)} arrays but params.npz holds "
                f"{len(data.files)}")
        vals = [_to_tensor(data[f"arr_{i}"], dt, lk, device)
                for i, (dt, lk) in enumerate(zip(manifest["dtypes"],
                                                 like_leaves))]
    return tree_unflatten(like, vals), manifest["step"]
