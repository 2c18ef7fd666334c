"""The training path's recompute in the port against the JAX package's.

JAX checkpoints two bodies of its training forward: ``blocked_attention``'s
KV-block body (``src/repro/models/attention.py``, ``@jax.checkpoint``) and
the Mamba chunk body of ``_fused_chunk_scan`` (``src/repro/models/ssm.py``).
The port checkpoints the first under autograd (``torch.utils.checkpoint``,
non-reentrant); the second is the fused selective scan's autograd
Function (``ops.SelectiveScan``), whose forward keeps the state before
each chunk and whose backward recomputes one chunk's states at a time
from it.  Checked, on the CPU from numpy draws:

* ``blocked_attention`` over 3 KV blocks keeps, per block, only what the
  JAX body's residuals hold (the carry and the block's keys, values and
  positions): no (B, Sq, KV, G, block) tensor is saved for the backward,
  where the loop before the recompute saved several a block;
* its output and gradients equal that loop's (a copy kept here) bit for
  bit, causal, non-causal (Whisper's encoder and cross-attention), with a
  window, with the value dim apart from the key dim (MLA) and in bf16;
* its gradients lie within ``ATTN_TOL`` of ``jax.grad`` of the JAX
  function on the same inputs;
* a Mamba layer's output and every gradient lie within ``GRAD_TOL`` of
  the layer before the recompute (a copy kept here: the K2 route over
  the whole sequence's (B, S, d_inner, N) coefficients), the fused
  scan's plain forward and backward running once each; and within
  ``GRAD_TOL`` of ``jax.grad`` of the JAX layer under its differentiable
  scan branches (``"xla"``, the checkpointed chunk scan, and
  ``"naive"``; the Pallas branch has no gradient), at 24 steps and at
  512, two of JAX's 256-step chunks, so its carry between chunks is on
  the path.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

# jax.grad of the JAX blocked_attention against the port's: max abs
# error per unit of the largest |JAX gradient| (at least 1), fp32 (the
# two frameworks sum the scores and p . v in other orders); measured
# worst 9.7e-7
ATTN_TOL = 1e-5
# a Mamba layer's gradients against jax.grad and against the K2 route:
# per leaf, per unit of its largest |gradient| floored at GRAD_FLOOR x the
# largest over all leaves, tests/test_torch_train.py's bounds; measured
# worst 1.6e-6
GRAD_TOL = 2e-3
GRAD_FLOOR = 1e-3

# (B, Sq, Skv, KV, G, hd, vd, causal, window): Skv over 3 blocks of 128
ATTN_CASES = {
    "causal": (2, 384, 384, 2, 2, 16, 16, True, 0),
    "noncausal": (2, 384, 384, 2, 1, 16, 16, False, 0),
    "cross": (2, 40, 384, 2, 2, 16, 16, False, 0),
    "window": (1, 384, 384, 1, 4, 16, 16, True, 100),
    "mla_vd": (1, 384, 384, 4, 1, 24, 16, True, 0),
}
BLOCK = 128


def _loop_before_recompute(q, k, v, *, q_positions, k_positions,
                           causal=True, window=0, scale=None,
                           block_size=1024):
    """``blocked_attention`` as it was before its blocks were
    checkpointed: every block's scores kept for the backward."""
    B, Sq, KV, G, hd = q.shape
    S_kv = k.shape[1]
    vd = v.shape[-1]
    blk = attention._pick_block(S_kv, block_size)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q32 = q.to(torch.float32)
    acc = torch.zeros((B, Sq, KV, G, vd), dtype=torch.float32)
    m = torch.full((B, Sq, KV, G), attention.NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32)
    qp = q_positions.to(torch.int64)[:, :, None, None, None]
    for t0 in range(0, S_kv, blk):
        ki = k[:, t0:t0 + blk].to(torch.float32)
        vi = v[:, t0:t0 + blk].to(torch.float32)
        kp = k_positions[:, t0:t0 + blk].to(torch.int64)[:, None, None,
                                                          None, :]
        s = torch.einsum("bqkgd,btkd->bqkgt", q32, ki) * scale
        mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool)
        if causal:
            mask = mask & (kp <= qp)
        if window > 0:
            mask = mask & ((qp - kp) < window)
        s = s.masked_fill(~mask, attention.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bqkgt,btkd->bqkgd", p, vi)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _attn_inputs(case, dtype=torch.float32):
    B, Sq, Skv, KV, G, hd, vd, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, KV, G, hd), (B, Skv, KV, hd), (B, Skv, KV, vd),
        (B, Sq, KV, G, vd)))
    # queries at the end of the key range (cross-attention has no order)
    qpos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq))
    kpos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv))
    kw = dict(causal=causal, window=window, block_size=BLOCK)
    return (q, k, v, ct, np.ascontiguousarray(qpos),
            np.ascontiguousarray(kpos), kw)


def _torch_grads(fn, q, k, v, ct, qpos, kpos, kw, dtype=torch.float32):
    qt, kt, vt = (torch.tensor(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = fn(qt, kt, vt, q_positions=torch.tensor(qpos),
             k_positions=torch.tensor(kpos), **kw)
    g = torch.autograd.grad((out.float() * torch.tensor(ct)).sum(),
                            [qt, kt, vt])
    return out.detach(), g


def test_blocked_attention_keeps_only_the_carry_across_blocks():
    """Over 3 KV blocks under grad, no (B, Sq, KV, G, block) tensor is
    saved for the backward (the loop before the recompute saved several
    a block); what is saved a block is the carry and the block's keys,
    values and positions, as the JAX body's residuals."""
    q, k, v, _, qpos, kpos, kw = _attn_inputs("causal")
    B, Sq, KV, G, _ = q.shape
    scores = (B, Sq, KV, G, BLOCK)

    def saved_by(fn):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        qt, kt, vt = (torch.tensor(x).requires_grad_() for x in (q, k, v))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(qt, kt, vt, q_positions=torch.tensor(qpos),
               k_positions=torch.tensor(kpos), **kw)
        return shapes

    before = saved_by(_loop_before_recompute)
    assert before.count(scores) >= 3, before
    now = saved_by(attention.blocked_attention)
    assert scores not in now, now
    # a block's keys and values, three times
    assert now.count((B, BLOCK, KV, q.shape[-1])) == 2 * 3, now
    # without grad nothing is saved, and the output is the same
    with torch.no_grad():
        args = [torch.tensor(x) for x in (q, k, v)]
        pos = dict(q_positions=torch.tensor(qpos),
                   k_positions=torch.tensor(kpos), **kw)
        assert torch.equal(attention.blocked_attention(*args, **pos),
                           _loop_before_recompute(*args, **pos))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blocked_attention_gradient_is_the_loop_s_bit_for_bit(case):
    q, k, v, ct, qpos, kpos, kw = _attn_inputs(case)
    out, g = _torch_grads(attention.blocked_attention, q, k, v, ct, qpos,
                          kpos, kw)
    want_out, want = _torch_grads(_loop_before_recompute, q, k, v, ct, qpos,
                                  kpos, kw)
    assert torch.equal(out, want_out)
    for a, b in zip(g, want):
        assert torch.equal(a, b)


def test_blocked_attention_bf16_gradient_is_the_loop_s_bit_for_bit():
    q, k, v, ct, qpos, kpos, kw = _attn_inputs("causal")
    out, g = _torch_grads(attention.blocked_attention, q, k, v, ct, qpos,
                          kpos, kw, torch.bfloat16)
    want_out, want = _torch_grads(_loop_before_recompute, q, k, v, ct, qpos,
                                  kpos, kw, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want_out)
    for a, b in zip(g, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blocked_attention_gradient_matches_jax(case):
    q, k, v, ct, qpos, kpos, kw = _attn_inputs(case)
    _, g = _torch_grads(attention.blocked_attention, q, k, v, ct, qpos,
                        kpos, kw)

    def f(qq, kk, vv):
        out = jattn.blocked_attention(qq, kk, vv, q_positions=qpos,
                                      k_positions=kpos, **kw)
        return jnp.sum(out * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    for name, a, b in zip("qkv", g, want):
        b = np.asarray(b)
        err = float(np.max(np.abs(a.numpy() - b))) / max(
            float(np.max(np.abs(b))), 1.0)
        assert err <= ATTN_TOL, (name, err)


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------

MAMBA = "falcon-mamba-7b"
MB = 2
# 24 steps (one chunk), 512 (two of JAX's 256-step chunks)
MAMBA_S = [24, 512]


def _mamba_before_recompute(params, x):
    """``mamba_forward`` as it was before its scan was checkpointed."""
    xa = x @ params["w_in_x"]
    z = x @ params["w_in_z"]
    xc = ssm._causal_conv(xa, params["conv_w"], params["conv_b"])
    xh = F.silu(xc.to(torch.float32)).to(x.dtype)
    dA, dBx, Cc = ssm._ssm_coeffs(params, xh)
    h, _ = scan_ops.linear_scan(dA, dBx)
    y = torch.einsum("bsdn,bsn->bsd", h, Cc.to(torch.float32))
    return ssm._gate_out(params, y, xh, z, x.dtype)


def _mamba_pair():
    jcfg = jax_get_arch(MAMBA).reduced()
    jm = jax_build_model(jcfg, LOCAL)
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: a[0], w["blocks"]["mamba"])
    tp = layer(params_from_numpy(w, device="cpu")["blocks"], 0)["mamba"]
    return jcfg, jp, tp


def _mamba_inputs(cfg, S):
    rng = np.random.default_rng(7)
    return (rng.standard_normal((MB, S, cfg.d_model)).astype(np.float32),
            rng.standard_normal((MB, S, cfg.d_model)).astype(np.float32))


def _grad_errors(got, want):
    """{leaf: max |got - want| per unit of want's largest magnitude,
    floored at GRAD_FLOOR of the largest over all leaves}."""
    want = {k: np.asarray(v) for k, v in want.items()}
    floor = GRAD_FLOOR * max(float(np.max(np.abs(v))) for v in want.values())
    return {k: float(np.max(np.abs(np.asarray(got[k]) - w))) / max(
        float(np.max(np.abs(w))), floor) for k, w in want.items()}


def _mamba_grads(fn, tp, x, ct, cfg=None):
    names = sorted(tp)
    leaves = [tp[n].detach().clone().requires_grad_() for n in names]
    xt = torch.tensor(x).requires_grad_()
    p = dict(zip(names, leaves))
    out = fn(p, xt, cfg) if cfg is not None else fn(p, xt)
    g = torch.autograd.grad((out * torch.tensor(ct)).sum(), leaves + [xt])
    return out.detach(), dict(zip(names + ["x"], g))


@pytest.mark.parametrize("S", MAMBA_S)
def test_mamba_gradient_is_the_layer_s_before_the_recompute(S, monkeypatch):
    """Every leaf and x within GRAD_TOL of the K2 route's (the whole
    sequence's coefficients, K2's plain forward and backward, the
    einsum): the fused scan's plain forward runs once, saving the chunk
    carries, and its plain backward once; K2 not at all."""
    _, _, tp = _mamba_pair()
    cfg = get_arch(MAMBA).reduced()
    x, ct = _mamba_inputs(cfg, S)
    want_out, want = _mamba_grads(_mamba_before_recompute, tp, x, ct)
    calls = []
    for name in ("selective_scan_ref", "selective_scan_backward_ref",
                 "linear_scan_ref", "linear_scan_backward_ref"):
        ref = getattr(scan_ops, name)

        def spy(*args, _ref=ref, _name=name, **kw):
            calls.append(_name)
            return _ref(*args, **kw)

        monkeypatch.setattr(scan_ops, name, spy)
    out, g = _mamba_grads(ssm.mamba_forward, tp, x, ct, cfg)
    assert calls == ["selective_scan_ref", "selective_scan_backward_ref"]
    assert float((out - want_out).abs().max()) <= 1e-5 * float(
        want_out.abs().max())
    errs = _grad_errors({k: v.numpy() for k, v in g.items()},
                        {k: v.numpy() for k, v in want.items()})
    assert max(errs.values()) <= GRAD_TOL, errs


@pytest.mark.parametrize("S", MAMBA_S)
@pytest.mark.parametrize("impl", ["xla", "naive"])
def test_mamba_gradient_matches_jax(impl, S):
    jcfg, jp, tp = _mamba_pair()
    cfg = get_arch(MAMBA).reduced()
    x, ct = _mamba_inputs(cfg, S)
    _, g = _mamba_grads(ssm.mamba_forward, tp, x, ct, cfg)
    dist = dataclasses.replace(LOCAL, scan_impl=impl)

    def f(p, xx):
        return jnp.sum(jssm.mamba_forward(p, xx, jcfg, dist) * ct)

    jg, jx = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    want = {**{k: np.asarray(v) for k, v in jg.items()}, "x": np.asarray(jx)}
    errs = _grad_errors({k: v.numpy() for k, v in g.items()}, want)
    assert max(errs.values()) <= GRAD_TOL, errs
