"""Shared local-work primitives for the algorithm strategies, the codec
of the engine's stacked client state, and the chaos layer's wire-side
helpers: the lossy upload codecs and the payload corruption."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.dtypes import resolve_state_storage
from repro_torch.common.pytree import (bcast_rows, tree_any_nan, tree_axpy,
                                       tree_l2_norm, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.core import client as client_lib


# ---------------------------------------------------------------------------
# Delta-compressed stacked client state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientStateCodec:
    """Encode/decode rule for the engine's stacked per-client state
    (``repro.core.algorithms.common.ClientStateCodec``, same arithmetic).

    ``anchor`` has the *state* structure: parameter-like leaves hold the
    (constant) reference model ``w0``, gradient-like slots hold zeros.
    ``mask`` mirrors it with a bool per leaf: ``False`` leaves (control
    scalars: round counters, sample counts) pass through untouched.
    Both directions are elementwise and broadcast over a leading
    stacked-client axis.

    Float dtypes store ``(x - anchor).to(dtype)`` and decode
    ``anchor + x.to(anchor.dtype)``.  Integer dtypes store the
    fixed-point code ``clip(round((x - anchor) / scale), -levels,
    levels)`` with a per-leaf fp32 ``scale`` and decode ``anchor +
    code * scale`` (two roundings, no fused multiply-add); codes are
    stable under re-encode, which keeps host-pool round trips
    idempotent.  ``scale`` leaves are 0-d fp32 tensors on the anchor's
    device, so the card divides exactly as the CPU does (a CUDA division
    by a Python scalar multiplies by its reciprocal).

    A ``dtype`` of fp32 (or ``anchor=None``) is the identity codec.
    """

    dtype: Any
    anchor: Any = None
    mask: Any = None
    # quantized codecs only: per-leaf fp32 scale tree + half-range
    scale: Any = None
    levels: Any = None

    @property
    def identity(self) -> bool:
        return self.anchor is None or self.dtype == torch.float32

    def encode(self, state):
        if self.identity:
            return state
        if self.levels is not None:
            lv = float(self.levels)
            return tree_map(
                lambda x, a, m, s: torch.clamp(
                    torch.round((x - a) / s), -lv, lv).to(self.dtype)
                if m else x,
                state, self.anchor, self.mask, self.scale)
        return tree_map(lambda x, a, m: (x - a).to(self.dtype) if m else x,
                        state, self.anchor, self.mask)

    def decode(self, state):
        if self.identity:
            return state
        if self.levels is not None:
            return tree_map(
                lambda x, a, m, s: a + x.to(a.dtype) * s if m else x,
                state, self.anchor, self.mask, self.scale)
        return tree_map(lambda x, a, m: a + x.to(a.dtype) if m else x,
                        state, self.anchor, self.mask)


def make_state_codec(cfg, anchor, mask):
    """The stacked-state codec for ``cfg.state_dtype``: None for fp32 (or
    None), the delta-cast codec for bf16 / fp16, the quantized delta
    codec with ``scale = cfg.state_qclip / levels`` for int8 / int4."""
    storage = resolve_state_storage(cfg.state_dtype)
    if storage is None or storage.dtype == torch.float32:
        return None
    scale = None
    if storage.quantized:
        qclip = float(getattr(cfg, "state_qclip", 0.5))
        if not qclip > 0.0:
            raise ValueError(
                f"state_qclip must be positive for quantized state dtype "
                f"{cfg.state_dtype!r}; got {qclip!r}")
        per_leaf = qclip / storage.levels
        scale = tree_map(lambda a: torch.full(
            (), per_leaf, dtype=torch.float32, device=a.device), anchor)
    return ClientStateCodec(dtype=storage.dtype, anchor=anchor, mask=mask,
                            scale=scale, levels=storage.levels)


# ---------------------------------------------------------------------------
# Lossy upload compression (the client -> server wire delta)
# ---------------------------------------------------------------------------

UPLOAD_CODECS = ("identity", "topk_sparse", "random_mask", "quantized_delta")


@dataclasses.dataclass(frozen=True)
class UploadCodec:
    """Lossy compressor for the client -> server upload stream
    (``repro.core.algorithms.common.UploadCodec``, same arithmetic).

    The engine applies ``encode`` inside the tick, between the local
    rounds and the server fold, to every slot of the cohort at once; the
    per-arrival oracles apply it to a cohort of one.  The fold consumes
    the lossily reconstructed dense delta, while ``leaf_bytes`` /
    ``tree_bytes`` account what the compressed form would cost on the
    wire — a pure function of the codec and the leaf shapes, which the
    schedulers' bandwidth-metered delay draws consume.

    * ``identity``: passthrough; full fp32 wire cost;
    * ``topk_sparse``: keep the ``ceil(frac * n)`` largest-|x| coordinates
      of each leaf (``torch.topk`` along each row), zero the rest;
    * ``random_mask``: keep a seeded-uniform ``k``-subset, rescaled by
      ``n / k``; the subset is ``jax.random.permutation``'s first ``k``
      under the slot's key (``repro_torch.common.prng``), so it equals
      the JAX package's bit for bit;
    * ``quantized_delta``: per-leaf symmetric uniform quantization to
      ``bits``-bit integers, ``round(x / scale) * scale`` with ``scale =
      max|x| * fp32(1 / (2^(bits-1) - 1))`` (two roundings; ``x / scale``
      divides by a tensor: a CUDA division by a Python scalar multiplies
      by its reciprocal).
    """

    name: str = "identity"
    frac: float = 0.1  # kept-coordinate fraction (topk_sparse/random_mask)
    bits: int = 8  # quantized_delta integer width

    @property
    def identity(self) -> bool:
        return self.name == "identity"

    @property
    def uses_rng(self) -> bool:
        """True when ``encode`` consumes the slots' PRNG keys."""
        return self.name == "random_mask"

    def _k(self, n: int) -> int:
        return max(1, min(n, int(math.ceil(self.frac * n))))

    def encode(self, delta, keys=None):
        """Lossy round trip of each slot's wire delta: ``delta`` a tree of
        ``(P, ...)`` leaves, ``keys`` the slots' ``(P, 2)`` PRNG keys
        (``random_mask`` only: leaf ``i`` takes ``fold_in(key, i)`` in
        flatten order, as the JAX codec does)."""
        if self.identity:
            return delta
        leaves = tree_leaves(delta)
        out = [self._encode_leaf(
            x, prng.fold_in(keys, i) if self.uses_rng else None)
            for i, x in enumerate(leaves)]
        return tree_unflatten(delta, out)

    def _encode_leaf(self, x: torch.Tensor, keys):
        P = x.shape[0]
        flat = x.reshape(P, -1)
        n = flat.shape[1]
        if self.name == "topk_sparse":
            keep = torch.topk(flat.abs(), self._k(n), dim=1).indices
            out = torch.zeros_like(flat).scatter(1, keep,
                                                 flat.gather(1, keep))
        elif self.name == "random_mask":
            k = self._k(n)
            keep = prng.permutation(keys, n)[:, :k]
            # rescale by n / k: the masked delta is unbiased in
            # expectation (the rand-k estimator)
            # (n / k as an fp32 scalar: JAX's weak-typed multiply)
            s = float(np.float32(n / k))
            out = torch.zeros_like(flat).scatter(1, keep,
                                                 flat.gather(1, keep) * s)
        else:  # quantized_delta
            lv = float(2 ** (self.bits - 1) - 1)
            # XLA lowers the JAX codec's max|x| / levels (a constant
            # divisor) to a multiply by levels' fp32 reciprocal: the same
            # here, so the codes equal the JAX package's bit for bit
            inv = float(np.float32(1.0) / np.float32(lv))
            amax = flat.abs().amax(dim=1, keepdim=True)
            scale = torch.where(amax > 0.0, amax * inv, 1.0)
            out = torch.clamp(torch.round(flat / scale), -lv, lv) * scale
        return out.reshape(x.shape)

    # -- wire-cost accounting (host side, pure) --------------------------
    def leaf_bytes(self, size: int, itemsize: int = 4) -> float:
        """Simulated wire bytes of one encoded leaf of ``size`` elements."""
        if self.name == "identity":
            return float(size * itemsize)
        k = self._k(size)
        if self.name == "topk_sparse":
            return float(k * (itemsize + 4))  # (value, index) pairs
        if self.name == "random_mask":
            return float(k * itemsize + 8)  # values + the mask seed
        return float(size) * self.bits / 8.0 + itemsize  # codes + scale

    def tree_bytes(self, tree) -> float:
        """Simulated wire bytes of one arrival's encoded delta tree (one
        model's leaves, no cohort axis): the ``upload_bytes`` the
        schedulers meter against ``bandwidth_bytes_per_s``."""
        return float(sum(self.leaf_bytes(x.numel(), x.element_size())
                         for x in tree_leaves(tree)))


def resolve_upload_codec(cfg) -> UploadCodec:
    """The run's :class:`UploadCodec` from ``RunConfig.upload_codec`` /
    ``upload_frac`` / ``upload_bits``, raising with the JAX package's
    messages on an unknown codec or out-of-range knobs."""
    name = getattr(cfg, "upload_codec", None) or "identity"
    if name not in UPLOAD_CODECS:
        raise ValueError(
            f"unknown upload_codec {name!r}; accepted: "
            + " | ".join(repr(n) for n in UPLOAD_CODECS))
    frac = float(getattr(cfg, "upload_frac", 0.1))
    bits = int(getattr(cfg, "upload_bits", 8))
    if not 0.0 < frac <= 1.0:
        raise ValueError(
            f"upload_frac must be in (0, 1], got {frac}")
    if not 2 <= bits <= 16:
        raise ValueError(
            f"upload_bits must be in [2, 16], got {bits}")
    return UploadCodec(name=name, frac=frac, bits=bits)


def upload_keys(key: torch.Tensor, t_arr: torch.Tensor,
                cid: torch.Tensor) -> torch.Tensor:
    """The slots' ``random_mask`` keys: ``fold_in(fold_in(key, t), cid)``
    per slot (``t_arr`` / ``cid`` of shape (P,)), with ``key`` the run's
    ``prng_key(seed)`` on the slots' device, as the JAX tick and oracle
    derive them."""
    return prng.fold_in(prng.fold_in(key, t_arr.to(torch.int64)),
                        cid.to(torch.int64))


# ---------------------------------------------------------------------------
# Wire-delta corruption (the chaos layer's payload faults)
# ---------------------------------------------------------------------------

# domain separator folded into the run seed for corruption noise keys, so
# the noise stream never collides with the upload codec's mask stream
CORRUPT_KEY_SALT = 104729  # 10000th prime


def corruption_key(key: torch.Tensor, t_arr: torch.Tensor,
                   cid: torch.Tensor) -> torch.Tensor:
    """The slots' corruption-noise keys, a pure function of (run seed,
    global iteration, client id): ``(P, 2)`` for ``t_arr`` / ``cid`` of
    shape (P,), with ``key`` the run's ``prng_key(seed)`` on the slots'
    device; equal to ``repro.core.algorithms.common.corruption_key`` bit
    for bit."""
    key = prng.fold_in(key, CORRUPT_KEY_SALT)
    return prng.fold_in(prng.fold_in(key, t_arr.to(torch.int64)),
                        cid.to(torch.int64))


def corrupt_wire_delta(delta, code: torch.Tensor, keys: torch.Tensor):
    """Each slot's payload corruption applied to its wire delta: ``delta``
    a tree of ``(P, ...)`` leaves, ``code`` the scheduler's (P,) wire
    codes (0 clean, 1 NaN fill, 2 Inf fill, 3 additive gaussian noise at
    5x the leaf's RMS), ``keys`` the slots' corruption keys.  Leaf ``i``
    draws its noise from ``fold_in(key, i)``; every slot's noise is drawn
    and the code selects, so no device value is read on the host."""
    out = []
    for i, x in enumerate(tree_leaves(delta)):
        noise = prng.normal(prng.fold_in(keys, i), x.shape[1:])
        c = bcast_rows(code, x)
        rms = torch.sqrt(torch.mean(torch.square(x).reshape(
            x.shape[0], -1), dim=1) + 1e-12)
        noisy = x + 5.0 * bcast_rows(rms, x) * noise
        out.append(torch.where(
            c == 1, float("nan"),
            torch.where(c == 2, float("inf"),
                        torch.where(c == 3, noisy, x))))
    return tree_unflatten(delta, out)


def admission(delta, stal: torch.Tensor, cfg):
    """The server's admission decision for each slot's wire delta:
    ``(ok, scale)``, both (P,), for ``delta`` a tree of ``(P, ...)``
    leaves and ``stal`` the slots' fp32 staleness.  Non-finite deltas are
    rejected; over ``cfg.max_staleness`` an arrival is rejected (or, under
    ``staleness_policy="downweight"``, scaled by max_staleness /
    staleness); a delta over ``cfg.max_delta_norm`` in L2 is scaled down
    to it.  The JAX tick's and oracle's arithmetic, in fp32, with every
    division by a tensor."""
    ok = ~tree_any_nan(delta)
    sc = torch.ones_like(stal)
    ms, mdn = cfg.max_staleness, cfg.max_delta_norm
    if ms is not None:
        over = stal > ms
        if cfg.staleness_policy == "downweight":
            sc = sc * torch.where(over, torch.full_like(stal, ms)
                                  / torch.clamp(stal, min=1e-9), 1.0)
        else:
            ok = ok & ~over
    if mdn is not None:
        nrm = tree_l2_norm(delta)
        sc = sc * torch.where(nrm > mdn, torch.full_like(nrm, mdn)
                              / torch.clamp(nrm, min=1e-30), 1.0)
    return ok, sc


def bool_tree(tree, flag: bool):
    """A tree of ``flag`` with ``tree``'s structure (codec mask helper)."""
    return tree_map(lambda _: flag, tree)


def avg_surrogate_grad(model, cfg):
    """Average grad of s_k over E minibatches (the per-round grad_s_k),
    for a whole cohort at once.

    Every minibatch is evaluated at the SAME params, so the average of the
    E per-batch gradients equals one gradient of the pooled (E*B) batch
    (batches are equal-sized; the lam prox term is affine and averages to
    itself) — one fused forward/backward, as in the JAX package.

    ``fn(params, server_params, xs, ys) -> (g, loss)`` with params stacked
    over the cohort axis P, ``xs`` of shape (P, E, B, ...), ``loss`` (P,).
    """

    def fn(params, server_params, xs, ys):
        P, E, B = xs.shape[:3]
        x = xs.reshape((P, E * B) + tuple(xs.shape[3:]))
        y = ys.reshape((P, E * B) + tuple(ys.shape[3:]))
        g, loss, _ = client_lib.surrogate_grad(
            model.loss, params, server_params,
            {"x": x, "y": y, "task": cfg.task}, cfg.lam,
        )
        return g, loss

    return fn


def sgd_epochs(model, cfg, mu: float = 0.0):
    """E minibatch prox-SGD steps (FedAvg mu=0 / FedProx mu>0 / FedAsync),
    for a whole cohort at once.

    ``fn(params, anchor, xs, ys) -> (params', train_loss)`` with params
    and anchor stacked over the cohort axis P, ``xs`` of shape (P, E, B,
    ...) and ``train_loss`` (P,): the mean of the E per-step losses, each
    taken before its update, as ``repro.core.algorithms.common.
    sgd_epochs`` reports it.  Each step takes every client's gradient
    from one backward pass of the summed per-client losses (the clients
    share no parameter).
    """

    def fn(params, anchor, xs, ys):
        p = params
        losses = []
        for e in range(xs.shape[1]):
            leaf = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            with torch.enable_grad():
                loss, _ = model.loss(leaf, {"x": xs[:, e], "y": ys[:, e],
                                            "task": cfg.task})
                grads = torch.autograd.grad(loss.sum(), list(leaf.values()))
            g = dict(zip(leaf, grads))
            if mu > 0.0:
                g = {k: g[k] + mu * (p[k] - anchor[k]) for k in g}
            p = tree_axpy(-cfg.eta, g, p)
            losses.append(loss.detach())
        return p, torch.stack(losses).mean(dim=0)

    return fn
