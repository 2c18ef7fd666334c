"""Mixture-of-Experts on one card: the dropless exact top-k combine.

Mirrors the single-device path of ``repro.models.moe``: ``moe_forward``
always takes ``moe_dense``, as the JAX ``moe_forward`` does without a
mesh.  The expert-parallel ``shard_map`` paths (``moe_ep_psum``,
``moe_ep_serve``) and the capacity that serves only them get no port.

``moe_dense`` computes JAX's function, ``y = sum_e gate_e(x) * FFN_e(x)``
over each token's top-k experts, without running every expert on every
token as the JAX reference does (64 / 6 ~ 10.7x the routed work for
DeepSeek-V2-Lite, 384 / 8 = 48x for Kimi-K2).  Two ways to run the
expert products, which ``_dispatch`` picks between by the call's token
count:

* ``_gathered`` (the prefill): the (token, slot) assignments are sorted by
  expert id, each expert runs its products on its contiguous slice of
  gathered rows, and the outputs go back to (token, slot) order.  The
  per-expert counts are read on the host once per call, one
  synchronisation a MoE layer;
* ``_all_experts`` (decode, a handful of tokens): one batched product over
  every expert and every token, which streams every expert's weights once
  and reads nothing on the host; the k routed outputs of each token are
  then picked out.

Both combine the same way: each token's k gated outputs in ascending
expert id, summed one after the other in fp32.  That is the JAX loop's
order (``y = y + mask_e * y_e`` for e = 0, 1, ...), whose terms for the
experts a token does not use add exact zeros.  Routing breaks ties at the
k-th probability toward the lower expert id, as ``lax.top_k`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamDef

def moe_spec(cfg: ModelConfig):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return {"router": ParamDef((d, E), init="fan_in"),
            "w_gate": ParamDef((E, d, f), init="fan_in"),
            "w_up": ParamDef((E, d, f), init="fan_in"),
            "w_down": ParamDef((E, f, d), init="fan_in")}


def _route(router_w, xt, k: int):
    """xt (T, d) -> (gates (T, k) fp32, ids (T, k) int64, aux load-balance
    loss).  The top k by probability, ties to the lower expert id (a
    stable descending sort: ``torch.topk`` promises no order on ties)."""
    logits = (xt @ router_w).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = top[:, :k], order[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balance aux: E * sum_e f_e * p_e
    E = logits.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(ids, E).to(torch.float32).sum(1).mean(0)
    return gates, ids, E * torch.sum(me * ce)


def _expert_ffn(buf, wg, wu, wd):
    """buf (E, C, d) -> (E, C, d): batched SwiGLU expert products, SiLU in
    fp32 and cast back, as the JAX code."""
    g = torch.matmul(buf, wg)
    u = torch.matmul(buf, wu)
    h = F.silu(g.to(torch.float32)).to(buf.dtype) * u
    return torch.matmul(h, wd)


def _gathered(params, xt, ids):
    """The routed rows only: (T, k, d) outputs in x's dtype, slot j of
    token t from expert ids[t, j]."""
    T, k = ids.shape
    E = params["w_gate"].shape[0]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)  # assignments by expert id
    counts = torch.bincount(flat, minlength=E).tolist()  # one host read
    rows = xt.index_select(0, order // k)
    out = torch.empty_like(rows)
    start = 0
    for e, c in enumerate(counts):
        if c:
            out[start:start + c] = _expert_ffn(
                rows[None, start:start + c], params["w_gate"][e:e + 1],
                params["w_up"][e:e + 1], params["w_down"][e:e + 1])[0]
        start += c
    ye = torch.empty_like(out)
    ye[order] = out
    return ye.view(T, k, -1)


def _all_experts(params, xt, ids):
    """Every expert on every token in one batched product, then the
    routed (T, k, d) outputs picked out."""
    E = params["w_gate"].shape[0]
    ye = _expert_ffn(xt[None].expand(E, -1, -1), params["w_gate"],
                     params["w_up"], params["w_down"])  # (E, T, d)
    tok = torch.arange(xt.shape[0], device=xt.device)[:, None]
    return ye[ids, tok]


# Every expert at once does T FLOPs a byte of bf16 weights for T tokens:
# under the H100's ridge (989 TFLOP/s over 3.35 TB/s, ~295) it costs one
# pass over the weights, whatever the batch.  The gathered rows read only
# the routed experts' weights but issue ~10 ops an expert after a host
# read: in decode on the H100 every expert at once ran 2.6-3.7x as fast
# on DeepSeek-V2-Lite (batch 8 and 16) and 0.90-1.22x (batch 8) and
# 1.27-1.75x (batch 16) as fast on Kimi-K2 (PERF.md; chip_smoke.py's
# ``serve_path_*_moe_decode``).
ALL_EXPERTS_MAX_TOKENS = 256


def _dispatch(n_tokens: int):
    """The expert products for a call of ``n_tokens`` tokens: every
    expert at once up to ALL_EXPERTS_MAX_TOKENS (decode), the gathered
    rows beyond (the prefill)."""
    return (_all_experts if n_tokens <= ALL_EXPERTS_MAX_TOKENS
            else _gathered)


def moe_dense(params, x, cfg: ModelConfig):
    """Capacity-free (dropless) exact top-k combine: x (B, S, d) ->
    (y (B, S, d) in x's dtype, aux)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    k = cfg.top_k
    gates, ids, aux = _route(params["router"], xt, k)
    # each token's slots in ascending expert id: the JAX loop's sum order
    ids, perm = torch.sort(ids, dim=-1)
    gates = torch.gather(gates, 1, perm)
    ye = _dispatch(xt.shape[0])(params, xt, ids)
    y = gates[:, 0, None] * ye[:, 0].to(torch.float32)
    for j in range(1, k):
        y = y + gates[:, j, None] * ye[:, j].to(torch.float32)
    return y.to(x.dtype).reshape(B, S, d), aux


def moe_forward(params, x, cfg: ModelConfig):
    """One card: always ``moe_dense``, as the JAX ``moe_forward`` does off
    a mesh."""
    return moe_dense(params, x, cfg)
