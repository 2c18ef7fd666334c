"""The port's copy of the JAX PRNG that the chaos layer consumes.

The upload codec ``random_mask`` and the wire corruption's noise draw
their randomness from ``jax.random`` keyed by (run seed, arrival stamp,
client id) in the JAX package.  This module reproduces those draws in
plain torch integer arithmetic, so the port's engine is held against the
JAX engine itself and the card reproduces the CPU's draws exactly:

* threefry-2x32 (20 rounds, Salmon et al. 2011) as the JAX reference
  lowers it, with ``jax_threefry_partitionable=True`` (JAX's default):
  a key is two 32-bit words, ``fold_in(key, d)`` hashes the counter pair
  ``(0, d)``, ``split(key, n)`` hashes ``(0, i)`` for ``i < n``, and the
  ``i``-th 32-bit draw of ``random_bits`` over a shape is the xor of the
  two words hashed from the 64-bit flat index ``(i >> 32, i & 0xffffffff)``;
* ``uniform`` by mantissa filling, ``normal = sqrt(2) * erfinv(u)`` on
  ``[nextafter(-1, 0), 1)``;
* ``permutation`` as ``ceil(3 ln n / ln(2^32 - 1))`` rounds of a stable
  sort on fresh 32-bit keys, each round splitting the key.

Keys, bits, uniforms and permutations equal ``jax.random``'s bit for bit;
normals agree within about 1e-5 relative (XLA's ``erf_inv`` is not
torch's).  Every 32-bit word is held in an int64 tensor and masked after
each add and shift, since torch has no full uint32 arithmetic.  A key is
an int64 tensor of shape ``(..., 2)``; every function batches over the
leading axes, one key a row.  Nothing here copies a value between host
and device: constants enter as Python scalars, so the draws add no
synchronizing call to a tick on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the fp32 bit pattern of 1.0: uniform fills its mantissa
_ONE_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``: int64 tensors holding uint32 values, broadcast
    against each other.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed (JAX's
    default, 64-bit types off): the words ``(0, seed mod 2^32)``, written
    on the device (no host copy)."""
    # made by device ops: an index assignment would copy from the host
    return torch.arange(2, dtype=torch.int64, device=device) * (
        int(seed) & MASK)


def _hash(key: torch.Tensor, hi, lo) -> torch.Tensor:
    """The key words hashed from counters ``(hi, lo)`` (tensors or ints),
    stacked on a new last axis: the shape of the broadcast of the key's
    leading axes with the counters'."""
    k1, k2 = key[..., 0], key[..., 1]
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` an int, or an integer tensor
    broadcast against the key's leading axes (one datum a row), taken
    modulo 2^32 as ``jnp.asarray(data, uint32)`` does."""
    if not isinstance(data, torch.Tensor):
        return _hash(key, 0, int(data) & MASK)
    data = data.to(torch.int64) & MASK
    return _hash(key, torch.zeros_like(data), data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)`` keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key.unsqueeze(-2), torch.zeros_like(i), i)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: ``(..., *shape)`` int64
    tensor of uint32 values, the key's leading axes first."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k = key.reshape(key.shape[:-1] + (1, 2))
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], i >> 32, i & MASK)
    return (y1 ^ y2).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in fp32: the top 23 bits fill the mantissa
    of a float in [1, 2), minus 1, then scaled to ``[minval, maxval)``."""
    bits = (random_bits(key, shape) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to fp32, as JAX converts them
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in fp32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


def permutation_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation`` over ``n`` items."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``(..., n)`` int64, one
    permutation of ``0 .. n-1`` a key."""
    lead = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        lead + (n,))
    for _ in range(permutation_rounds(n)):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x
