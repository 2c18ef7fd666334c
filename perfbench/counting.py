"""The operations and bytes that a function needs, counted from its
shapes, whatever implements it; and the least time the H100 could take
for them (``peaks``).  A kernel's roofline share is that least time over
its measured time; an MFU is the model's matrix-product operations over
the measured time at the peak rate.

Recomputation is never counted: a backward that recomputes its forward
does more work than the function needs, and the share says so.
"""
from __future__ import annotations

from perfbench import peaks

# fp32 operations an element of the Eq. (5)-(6) feature pass: |w|, max,
# sub, exp, sum, w*w + sum, divide, scale by w, out*out + sum, rescale
FEATURE_OPS_PER_ELEM = 12
# one expf on sm_90a: 6 FP32-pipe instructions and one MUFU.EX2
EXPF_FP32, EXPF_EX2 = 6, 1
# the selective scan's backward an element, each product and sum rounded
# alone: 23 products and sums and one expf (the state recomputed once)
SCAN_BWD_FP32 = 23 + EXPF_FP32


def feature_pass_bound_s(rows: int, cols: int, itemsize: int = 4) -> float:
    """K1's per-row pass over a (rows, cols) table: the table read once
    and written once over HBM, against its fp32 operations."""
    bytes_s = 2 * rows * cols * itemsize / peaks.HBM_BYTES_PER_S
    ops_s = FEATURE_OPS_PER_ELEM * rows * cols / peaks.FP32_FLOPS
    return max(bytes_s, ops_s)


def _pipes_bound_s(elems: int, fp32_per_elem: float, ex2_per_elem: float,
                   nbytes: int) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               elems * fp32_per_elem / peaks.FP32_INSTR_PER_S,
               elems * ex2_per_elem / peaks.EX2_PER_S)


def scan_fwd_bound_s(B: int, S: int, di: int, N: int,
                     itemsize: int) -> float:
    """The fused selective scan ``y = h . C`` with ``h = exp(dt A) h +
    (dt B) x``: xh (``itemsize`` bytes), dt, bc, A read once, y and
    h_last written once; an element (b, s, d, n) takes dt A, expf, dt B,
    times x, dA h, plus dBx, h C and, but for n = 0, the sum into y."""
    elems = B * S * di * N
    fp32 = 6 + EXPF_FP32 + (N - 1) / N
    nbytes = (B * S * di * (itemsize + 4 + 4) + B * S * 2 * N * itemsize
              + di * N * 4 + B * di * N * 4)
    return _pipes_bound_s(elems, fp32, EXPF_EX2, nbytes)


def scan_bwd_bound_s(B: int, S: int, di: int, N: int, chunk: int) -> float:
    """The fused selective scan's backward in fp32: xh, dt, gy, bc, A,
    the chunk carries (B, S / chunk, di, N) and gh_last read once, dxh,
    ddt, dA and dbc written once; SCAN_BWD_FP32 FP32-pipe instructions
    and one MUFU.EX2 an element."""
    elems = B * S * di * N
    nbytes = 4 * (5 * B * S * di + 2 * B * S * 2 * N + 2 * di * N
                  + B * (S // chunk) * di * N + B * di * N)
    return _pipes_bound_s(elems, SCAN_BWD_FP32, EXPF_EX2, nbytes)


def scan_chunk(S: int) -> int:
    """The scan's chunk: ``min(256, S)``, halved until it divides S."""
    c = min(256, S)
    while S % c:
        c //= 2
    return c


# ---------------------------------------------------------------------------
# Matrix-product operations of a model, from its sizes
# ---------------------------------------------------------------------------

def mamba_layer_params(d: int, di: int, N: int, R: int) -> int:
    """Weights a token multiplies in one Mamba-1 layer: the x and z
    in-projections, dt's low-rank pair, the B / C projection and the
    out-projection."""
    return 2 * d * di + di * R + R * di + di * 2 * N + di * d


def mla_params(d: int, H: int, r: int, dn: int, dr: int, dv: int) -> int:
    """MLA with q at full rank: wq, the latent and rotary-key
    projections, the up-projections of k and v, the output."""
    return d * H * (dn + dr) + d * r + d * dr + r * H * dn + r * H * dv \
        + H * dv * d


def attention_flops(S: int, H: int, dqk: int, dv: int) -> float:
    """Causal self-attention's score and value products over one
    sequence, forward: half of the S x S pairs."""
    return 2.0 * H * S * S / 2 * (dqk + dv)


def train_flops_per_token(matmul_params: int) -> float:
    """Forward and backward: 6 operations a weight a token."""
    return 6.0 * matmul_params


def model_matmul(cfg: dict, L: int, seq: int):
    """(weights a token multiplies, attention's forward operations a
    sequence) of a configuration file's sizes at depth ``L`` and ``seq``
    positions, the head included; MoE counts the experts a token is
    routed to."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    if cfg["family"] == "ssm":
        per = mamba_layer_params(d, cfg["intermediate_size"],
                                 cfg["state_size"], cfg["time_step_rank"])
        return L * per + d * V, 0.0
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    attn = mla_params(d, H, r, dn, dr, dv)
    nd = min(cfg["first_k_dense_replace"], L)
    dense = attn + 3 * d * cfg["intermediate_size"]
    fe = cfg["moe_intermediate_size"]
    moe = (attn + d * cfg["n_routed_experts"]
           + cfg["num_experts_per_tok"] * 3 * d * fe
           + 3 * d * cfg["n_shared_experts"] * fe)
    return (nd * dense + (L - nd) * moe + d * V,
            L * attention_flops(seq, H, dn + dr, dv))
