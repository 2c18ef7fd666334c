"""Falcon-Mamba's and DeepSeek-V2-Lite's forward passes and training
loss, plain, in fp32, as the configuration files state them (their
``departures`` included), over the weights in the port's layout.

``sizes`` is a configuration file's dict; ``layers`` the depth held.
Each layer's weights are read from the layer-stacked leaves and cast to
fp32 as they are used, so a bf16 model is upcast one layer at a time.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

RMS_EPS = 1e-6  # the port's, a departure named in the configuration files
AUX_WEIGHT = 0.01


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def layer(stacked, i: int):
    if isinstance(stacked, torch.Tensor):
        return f32(stacked[i])
    return {k: layer(v, i) for k, v in stacked.items()}


def rmsnorm(x, scale, eps: float = RMS_EPS):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * scale


def swiglu(P: Precision, p, x):
    h = F.silu(P.mm(x, p["w_gate"])) * P.mm(x, p["w_up"])
    return P.mm(h, p["w_down"])


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

def scan(xh, dt, A, Bm, Cm, chunk: int = 32):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from zero, y_t = h_t C_t:
    xh, dt (b, S, di), A (di, N), Bm, Cm (b, S, N) -> y (b, S, di).
    The coefficients are formed a chunk of steps at a time and the
    recurrence walks the steps in order."""
    b, S, di = xh.shape
    h = xh.new_zeros((b, di, A.shape[1]))
    ys = []
    for s0 in range(0, S, chunk):
        dtc = dt[:, s0:s0 + chunk, :, None]
        dA = torch.exp(dtc * A)
        dBx = (dtc * xh[:, s0:s0 + chunk, :, None]) \
            * Bm[:, s0:s0 + chunk, None, :]
        hs = []
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            hs.append(h)
        ys.append((torch.stack(hs, 1) * Cm[:, s0:s0 + chunk, None, :])
                  .sum(-1))
    return torch.cat(ys, 1)


def mamba_mixer(P: Precision, p, x, N: int):
    K = p["conv_w"].shape[0]
    xa = P.mm(x, p["w_in_x"])
    z = P.mm(x, p["w_in_z"])
    xp = F.pad(xa, (0, 0, K - 1, 0))
    S = x.shape[1]
    xc = sum(xp[:, j:j + S] * p["conv_w"][j] for j in range(K)) \
        + p["conv_b"]
    xh = F.silu(xc)
    dt = F.softplus(P.mm(P.mm(xh, p["w_x_dt"]), p["w_dt"]) + p["b_dt"])
    bc = P.mm(xh, p["w_x_bc"])
    y = scan(xh, dt, -torch.exp(p["A_log"]), bc[..., :N], bc[..., N:])
    y = (y + p["D"] * xh) * F.silu(z)
    return P.mm(y, p["w_out"])


# ---------------------------------------------------------------------------
# DeepSeek-V2: MLA, the dense FFN, the routed and shared experts
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x (..., S, H, hd): pairs (x[:half], x[half:]) rotated by
    positions / theta^(i / half)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32)
                             / half))
    ang = positions[:, None].to(torch.float32).cpu() * freqs
    cos = torch.cos(ang).to(x.device)[:, None, :]
    sin = torch.sin(ang).to(x.device)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def mla(P: Precision, p, x, sz: Dict):
    B, S, d = x.shape
    H, r = sz["num_attention_heads"], sz["kv_lora_rank"]
    dn, dr, dv = (sz["qk_nope_head_dim"], sz["qk_rope_head_dim"],
                  sz["v_head_dim"])
    pos = torch.arange(S, device=x.device)
    q = P.mm(x, p["wq"].reshape(d, -1)).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, sz["rope_theta"])],
                  -1)
    c = rmsnorm(P.mm(x, p["w_dkv"]), p["kv_norm"])
    k_r = rope(P.mm(x, p["w_kr"])[:, :, None, :], pos, sz["rope_theta"])
    k_nope = P.mm(c, p["w_uk"].reshape(r, -1)).view(B, S, H, dn)
    v = P.mm(c, p["w_uv"].reshape(r, -1)).view(B, S, H, dv)
    k = torch.cat([k_nope, k_r.expand(B, S, H, dr)], -1)
    s = P.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
        / math.sqrt(dn + dr)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = P.mm(torch.softmax(s, -1), v.transpose(1, 2))  # (B, H, S, dv)
    return P.mm(o.transpose(1, 2).reshape(B, S, H * dv),
                p["wo"].reshape(H * dv, d))


def moe(P: Precision, p, x, sz: Dict):
    """The routed experts: (y, load-balance term).  Each token's top k
    experts by router probability (ties to the lower id), gates
    renormalized to sum to 1, expert e's SwiGLU on the tokens routed to
    it."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    E, k = sz["n_routed_experts"], sz["num_experts_per_tok"]
    probs = torch.softmax(P.mm(xt, p["router"]), -1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    ids = ids[:, :k]
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            pe = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
            y = y.index_add(0, tok, gates[tok, slot, None]
                            * swiglu(P, pe, xt[tok]))
    frac = F.one_hot(ids, E).to(torch.float32).sum(1).mean(0)
    aux = E * torch.sum(probs.mean(0) * frac)
    return y.view(B, S, d), aux


# ---------------------------------------------------------------------------
# The trunk
# ---------------------------------------------------------------------------

def hidden(P: Precision, w, tokens, sz: Dict, layers: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final normed hidden states (B, S, d), the summed load-balance
    terms)."""
    x = f32(w["embed"]["table"][tokens.long()])
    aux = x.new_zeros(())
    if sz["family"] == "ssm":
        for i in range(layers):
            p = layer(w["blocks"], i)
            x = x + mamba_mixer(P, p["mamba"], rmsnorm(x, p["ln"]["scale"]),
                                sz["state_size"])
    else:
        nd = min(sz["first_k_dense_replace"], layers)
        for i in range(layers):
            dense = i < nd
            p = layer(w["dense_blocks" if dense else "moe_blocks"],
                      i if dense else i - nd)
            x = x + mla(P, p["attn"], rmsnorm(x, p["ln1"]["scale"]), sz)
            h = rmsnorm(x, p["ln2"]["scale"])
            if dense:
                x = x + swiglu(P, p["mlp"], h)
            else:
                y, a = moe(P, p["moe"], h, sz)
                x = x + y + swiglu(P, p["shared"], h)
                aux = aux + a
    return rmsnorm(x, f32(w["final_norm"]["scale"])), aux


def head(w, sz: Dict) -> torch.Tensor:
    if sz.get("tie_word_embeddings"):
        return f32(w["embed"]["table"]).T
    return f32(w["lm_head"]["w"])


def loss(P: Precision, w, tokens, labels, sz: Dict, layers: int):
    """Mean token cross-entropy plus AUX_WEIGHT times the load-balance
    terms."""
    x, aux = hidden(P, w, tokens, sz, layers)
    logits = P.mm(x, head(w, sz))
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1).long())
    return ce + AUX_WEIGHT * aux


def last_logits(P: Precision, w, tokens, sz: Dict, layers: int):
    """The logits (b, V) after the last position of each prompt."""
    x, _ = hidden(P, w, tokens, sz, layers)
    return P.mm(x[:, -1], head(w, sz))
