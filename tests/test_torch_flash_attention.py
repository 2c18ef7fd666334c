"""The port's flash attention (K3) against the JAX package's.

On the CPU the port's dispatcher runs its plain PyTorch version (a dense
masked softmax); it is held against the JAX plain version and against
the JAX Pallas kernel in interpret mode, on the case x dtype grid of
``tests/test_kernels.py``, on the served models' head layouts
(TinyLlama's, RecurrentGemma's MQA at head dim 256 with a window that
binds, and Kimi-K2's GQA at head dim 112: causal, windowed and
non-causal), a ragged length, a window and non-contiguous positions over
a padded cache.  The
CUDA kernel itself is checked on the card (``cuda`` marker; skipped
where there is none).  Inputs come from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_attention)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    HEAD_DIMS, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.models.decode import INT_SENTINEL  # noqa: E402

# B, Sq, Skv, KV, G, hd, causal, window: tests/test_kernels.py's CASES
CASES = [
    (2, 128, 128, 2, 2, 64, True, 0),
    (1, 256, 256, 1, 4, 32, True, 64),
    (2, 64, 64, 4, 1, 64, False, 0),
    (1, 128, 128, 2, 4, 128, True, 32),
    (1, 512, 512, 1, 1, 64, True, 128),
]
# TinyLlama-1.1B's head layout (H 32, KV 4, G 8, hd 64) at small S, a
# ragged length, and a window at that width
MODEL_CASES = [
    (2, 64, 64, 4, 8, 64, True, 0),
    (1, 100, 100, 4, 8, 64, True, 0),
    (1, 130, 130, 4, 8, 64, True, 48),
]
# RecurrentGemma-9B's head layout at head dim 256 (MQA: KV 1, G 16) at
# small S, causal, with its local window made to bind (32 < S) and not
# (0), and a ragged length
HD256_CASES = [
    (1, 96, 96, 1, 16, 256, True, 32),
    (2, 64, 64, 1, 16, 256, True, 0),
    (1, 100, 100, 1, 16, 256, True, 48),
]
# Kimi-K2's head dim 112 (GQA, 8 heads a KV head there) at small S:
# causal, a window that binds on a ragged length, and non-causal
HD112_CASES = [
    (2, 64, 64, 2, 8, 112, True, 0),
    (1, 100, 100, 2, 4, 112, True, 32),
    (1, 96, 96, 2, 4, 112, False, 0),
]
# max abs error per unit of the output's largest magnitude (at least 1):
# tests/test_kernels.py's bounds
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(case, seed=5):
    B, Sq, Skv, KV, G, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _arange(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, tol, tag=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, tag
    err = float(np.max(np.abs(got - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, f"{tag}: max abs err {err} > {bound}"


def _both(q, k, v, qp, kp, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    tx = [torch.tensor(a).to(tdt) for a in (q, k, v)]
    return jx, tx, jnp.asarray(qp), jnp.asarray(kp), torch.tensor(
        qp), torch.tensor(kp)


@pytest.mark.parametrize("case", CASES + MODEL_CASES + HD256_CASES
                         + HD112_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_matches_jax_ref_and_pallas_interpret(case, dtype):
    B, Sq, Skv, KV, G, hd, causal, window = case
    q, k, v = _qkv(case)
    (jq, jk, jv), (tq, tk, tv), jqp, jkp, tqp, tkp = _both(
        q, k, v, _arange(B, Sq), _arange(B, Skv), dtype)
    got = flash_attention(tq, tk, tv, q_positions=tqp, k_positions=tkp,
                          causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == q.shape
    kw = dict(q_positions=jqp, k_positions=jkp, causal=causal,
              window=window)
    for use_kernel in (False, True):  # JAX plain, then Pallas interpret
        want = jax_flash_attention(jq, jk, jv, use_kernel=use_kernel,
                                   interpret=True, **kw)
        _assert_close(got, want, DTYPES[dtype][2], f"use_kernel={use_kernel}")


@pytest.mark.parametrize("window", [0, 24])
def test_kernel_layout_ref_matches_jax_on_padded_cache(window):
    """Non-contiguous positions: 16 queries at 40..55 over a 64-slot cache
    whose slots past 55 hold INT_SENTINEL, in the kernel layout."""
    B, Sq, Skv, KV, G, hd = 2, 16, 64, 2, 4, 32
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, KV * G, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Skv, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Skv, hd)).astype(np.float32)
    qp = np.broadcast_to(40 + np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kp = np.arange(Skv, dtype=np.int32)
    kp = np.broadcast_to(np.where(kp < 56, kp, INT_SENTINEL).astype(
        np.int32), (B, Skv)).copy()
    got = flash_attention_ref(*(torch.tensor(a) for a in (q, k, v, qp, kp)),
                              causal=True, window=window)
    want = jax_flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v, qp,
                                                              kp)),
                                   causal=True, window=window)
    _assert_close(got, want, 2e-5)
    # and through the dispatcher's model layout
    got_m = flash_attention(
        torch.tensor(q.reshape(B, KV, G, Sq, hd).transpose(0, 3, 1, 2, 4)),
        torch.tensor(k.transpose(0, 2, 1, 3)),
        torch.tensor(v.transpose(0, 2, 1, 3)), q_positions=torch.tensor(qp),
        k_positions=torch.tensor(kp), causal=True, window=window,
        contiguous=False)
    _assert_close(got_m.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd),
                  want, 2e-5)


def test_gqa_head_order():
    """Head h = kv * G + g reads KV head h // G: with v constant per KV
    head, every query head's output is its KV head's constant."""
    B, S, KV, G, hd = 1, 8, 3, 2, 32
    q = torch.randn(B, S, KV, G, hd,
                    generator=torch.Generator().manual_seed(0))
    k = torch.zeros(B, S, KV, hd)
    v = torch.arange(KV, dtype=torch.float32)[None, None, :, None].expand(
        B, S, KV, hd).contiguous()
    pos = torch.arange(S, dtype=torch.int32)[None]
    out = flash_attention(q, k, v, q_positions=pos, k_positions=pos)
    want = torch.arange(KV, dtype=torch.float32)[None, None, :, None, None]
    assert torch.equal(out, want.expand_as(out))


def test_cpu_tensor_takes_plain_version_without_launching():
    case = MODEL_CASES[0]
    B, Sq, Skv = case[:3]
    q, k, v = (torch.tensor(a) for a in _qkv(case))
    pos = torch.tensor(_arange(B, Sq))
    before = flash_attention_kernel.launches
    for use_kernel in (None, False):
        got = flash_attention(q, k, v, q_positions=pos, k_positions=pos,
                              use_kernel=use_kernel)
    assert flash_attention_kernel.launches == before
    want = flash_attention_ref(
        q.permute(0, 2, 3, 1, 4).reshape(B, -1, Sq, q.shape[-1]),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), pos, pos)
    assert torch.equal(
        got.permute(0, 2, 3, 1, 4).reshape(want.shape), want)


def test_kernel_forced_on_cpu_raises():
    case = MODEL_CASES[0]
    q, k, v = (torch.tensor(a) for a in _qkv(case))
    pos = torch.tensor(_arange(case[0], case[1]))
    with pytest.raises(ValueError, match="use_kernel=True"):
        flash_attention(q, k, v, q_positions=pos, k_positions=pos,
                        use_kernel=True)


@pytest.mark.parametrize("hd,refusal", [(112, "CUDA tensors"),
                                        (96, "head_dim"), (48, "head_dim")])
def test_kernel_wrapper_head_dims(hd, refusal):
    """The wrapper takes Kimi-K2's head dim 112 (its checks pass on to the
    device, where a CPU tensor is refused) and refuses a head dim the
    kernel has no build for, before any launch."""
    assert HEAD_DIMS == (32, 64, 112, 128, 256)
    q, k, v = (torch.tensor(a) for a in _qkv((1, 8, 8, 2, 2, hd, True, 0)))
    pos = torch.tensor(_arange(1, 8))
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match=refusal):
        flash_attention_kernel(q, k, v, pos, pos, causal=True, window=0,
                               contiguous=True)
    assert flash_attention_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    case = MODEL_CASES[0]
    q, k, v = (torch.tensor(a) for a in _qkv(case))
    pos = torch.tensor(_arange(case[0], case[1]))
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_kernel(q, k, v, pos, pos, causal=True, window=0,
                               contiguous=True)
    assert flash_attention_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + MODEL_CASES + HD256_CASES
                         + HD112_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, Sq, Skv, KV, G, hd, causal, window = case
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.tensor(a).to(tdt).cuda() for a in _qkv(case))
    qp = torch.tensor(_arange(B, Sq)).cuda()
    kp = torch.tensor(_arange(B, Skv)).cuda()
    before = flash_attention_kernel.launches
    got = flash_attention(q, k, v, q_positions=qp, k_positions=kp,
                          causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = flash_attention_ref(
        q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), qp, kp,
        causal=causal, window=window)
    want = want.reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
    assert got.dtype == tdt
    _assert_close(got.cpu(), want.cpu(), tol)


# The kernel's own edge cases on the card, for both designs (bf16 on the
# tensor cores, fp32 on the CUDA cores) at every head dim: ragged lengths
# (the last 64-key tile and 128-row q tile partly past the sequence),
# a window, Sq != Skv, decode-like queries over a padded cache
# (INT_SENTINEL slots, not contiguous), and fully masked rows (queries
# before every key), which return the mean of v over all keys on both
# sides when every tile is visited.
EDGE_KINDS = ["ragged100", "ragged2016", "window", "sq_ne_skv",
              "padded_cache", "fully_masked"]


def _edge_case(kind, hd, seed=11):
    """(q, k, v, q_pos, k_pos, causal, window, contiguous) as numpy."""
    B, KV, G = 1, 2, 2
    Sq, Skv, window, contiguous, q_off = {
        "ragged100": (100, 100, 0, True, 0),
        "ragged2016": (2016, 2016, 0, True, 0),
        "window": (300, 300, 48, True, 0),
        "sq_ne_skv": (100, 300, 0, True, 0),
        "padded_cache": (64, 2048, 0, False, 1000),
        "fully_masked": (64, 300, 0, False, 236),
    }[kind]
    q, k, v = _qkv((B, Sq, Skv, KV, G, hd, True, window), seed)
    q_pos = _arange(B, Sq) + q_off
    k_pos = _arange(B, Skv)
    if kind == "padded_cache":
        k_pos = np.where(k_pos < q_off + Sq, k_pos, INT_SENTINEL).astype(
            np.int32)
    if kind == "fully_masked":
        q_pos[:, :5] = -3
    return q, k, v, q_pos, k_pos, True, window, contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("hd", list(HEAD_DIMS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_edge_cases(kind, hd, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, qp, kp, causal, window, contiguous = _edge_case(kind, hd)
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.tensor(a).to(tdt).cuda() for a in (q, k, v))
    qp, kp = torch.tensor(qp).cuda(), torch.tensor(kp).cuda()
    B, Sq, KV, G, _ = q.shape
    before = flash_attention_kernel.launches
    got = flash_attention(q, k, v, q_positions=qp, k_positions=kp,
                          causal=causal, window=window,
                          contiguous=contiguous)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = flash_attention_ref(
        q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), qp, kp,
        causal=causal, window=window)
    want = want.reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    _assert_close(got.cpu(), want.cpu(), tol, kind)
