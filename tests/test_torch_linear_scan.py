"""The port's linear recurrence and fold prefix against the JAX package's.

On the CPU the port's dispatcher runs its plain PyTorch version; it is
held against the JAX plain version and against the JAX Pallas kernel in
interpret mode, on the shape x dtype grid of ``tests/test_kernels.py``,
and the port's ``fold_prefix`` against the JAX one.  The CUDA kernel
itself is checked on the card (``cuda`` marker; skipped where there is
none).  Inputs come from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.linear_scan.ops import (  # noqa: E402
    fold_prefix as jax_fold_prefix, linear_scan as jax_linear_scan)
from repro.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_ref as jax_linear_scan_ref)
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_kernel)
from repro_torch.kernels.linear_scan.ops import (  # noqa: E402
    fold_prefix, linear_scan)
from repro_torch.kernels.linear_scan.ref import linear_scan_ref  # noqa: E402

SHAPES = [(2, 64, 32), (1, 128, 16), (2, 100, 8), (1, 256, 128),
          (2, 32, 4)]
# max abs error per unit of the output's largest magnitude (at least 1):
# with a up to 0.999 the state reaches |h| of 10-30, where the two
# frameworks' rounding (fused or separate multiply-add) differs by ulps
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(shape, seed=11):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, tol, tag=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, tag
    err = float(np.max(np.abs(got - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err < bound, f"{tag}: max abs err {err} >= {bound}"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_matches_jax_ref_and_pallas_interpret(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _inputs(shape)
    a_t, b_t = torch.tensor(a).to(tdt), torch.tensor(b).to(tdt)
    a_j, b_j = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    # both frameworks round fp32 -> bf16 to nearest even: same inputs
    np.testing.assert_array_equal(_np32(b_t), _np32(b_j))
    h, h_last = linear_scan(a_t, b_t)
    assert h.dtype == tdt and h_last.dtype == tdt
    for tag, (want, want_last) in [
            ("ref", jax_linear_scan_ref(a_j, b_j)),
            ("pallas", jax_linear_scan(a_j, b_j, use_kernel=True,
                                       interpret=True))]:
        _assert_close(h, want, tol, tag)
        _assert_close(h_last, want_last, tol, tag)


def test_mamba_layout_flattens_trailing_axes():
    a, b = _inputs((2, 64, 16, 4))
    h, h_last = linear_scan(torch.tensor(a), torch.tensor(b))
    assert tuple(h.shape) == (2, 64, 16, 4)
    assert tuple(h_last.shape) == (2, 16, 4)
    want, want_last = jax_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                      use_kernel=False)
    _assert_close(h, want, 2e-5)
    _assert_close(h_last, want_last, 2e-5)


def test_plain_version_broadcasts_a_over_channels():
    """(B, S, 1) coefficients — the fold's layout — equal the same
    coefficients materialized over every channel."""
    a, b = _inputs((2, 13, 5))
    a1 = torch.tensor(a[:, :, :1])
    h, h_last = linear_scan_ref(a1, torch.tensor(b))
    h2, h2_last = linear_scan_ref(a1.expand(2, 13, 5), torch.tensor(b))
    assert torch.equal(h, h2) and torch.equal(h_last, h2_last)


def _fold_inputs(S, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, S).astype(np.float32)
    b = {"m": rng.standard_normal((S, 6, 4)).astype(np.float32),
         "v": rng.standard_normal((S,)).astype(np.float32),
         "w": {"x": rng.standard_normal((S, 3)).astype(np.float32)}}
    h0 = {"m": rng.standard_normal((6, 4)).astype(np.float32),
          "v": np.float32(rng.standard_normal()),
          "w": {"x": rng.standard_normal(3).astype(np.float32)}}
    return a, b, h0


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("S", [1, 3, 8, 13])
@pytest.mark.parametrize("seeded", [False, True])
def test_fold_prefix_matches_jax_and_sequential(S, seeded):
    """Mixed leaf ranks, a nested leaf, non-power-of-two S, with and
    without a carried-in state h0."""
    a, b, h0 = _fold_inputs(S)
    to_t = lambda tree: {k: to_t(v) if isinstance(v, dict)  # noqa: E731
                         else torch.tensor(v) for k, v in tree.items()}
    to_j = lambda tree: {k: to_j(v) if isinstance(v, dict)  # noqa: E731
                         else jnp.asarray(v) for k, v in tree.items()}
    got = fold_prefix(torch.tensor(a), to_t(b), to_t(h0) if seeded else None)
    want = jax_fold_prefix(jnp.asarray(a), to_j(b),
                           to_j(h0) if seeded else None)
    got, want, bl = _leaves(got), _leaves(want), _leaves(b)
    h = {k: (np.asarray(v, np.float32) if seeded
             else np.zeros_like(bl[k][0])) for k, v in _leaves(h0).items()}
    for k in bl:
        seq = np.zeros_like(bl[k])
        for s in range(S):  # the sequential fold, one arrival at a time
            h[k] = a[s] * h[k] + bl[k][s]
            seq[s] = h[k]
        assert got[k].dtype == torch.float32 and got[k].shape == seq.shape
        _assert_close(got[k], want[k], 2e-5, f"{k} vs jax")
        _assert_close(got[k], seq, 2e-5, f"{k} vs sequential")


def test_cpu_tensor_takes_plain_version():
    a, b = _inputs((1, 8, 4))
    for use_kernel in (None, False):
        h, _ = linear_scan(torch.tensor(a), torch.tensor(b),
                           use_kernel=use_kernel)
        assert torch.equal(h, linear_scan_ref(torch.tensor(a),
                                              torch.tensor(b))[0])


def test_kernel_forced_on_cpu_raises():
    a, b, _ = _fold_inputs(3)
    with pytest.raises(ValueError, match="fold_kernel=True"):
        fold_prefix(torch.tensor(a), {"v": torch.tensor(b["v"])},
                    use_kernel=True)
    x, y = _inputs((1, 8, 4))
    with pytest.raises(ValueError, match="contradicts"):
        linear_scan(torch.tensor(x), torch.tensor(y), use_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = linear_scan_kernel.launches
    a, b = _inputs((1, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        linear_scan_kernel(torch.tensor(a), torch.tensor(b))
    assert linear_scan_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,broadcast", [
    *((s, False) for s in SHAPES),
    ((1, 64, 16384), True), ((1, 64, 1), True), ((1, 1, 300), True),
    ((1, 13, 2048), True), ((1, 256, 62720), True), ((4, 4096, 1024), False),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_plain_version(shape, broadcast, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, tdt, tol = DTYPES[dtype]
    a, b = _inputs(shape)
    if broadcast:
        a = a[:, :, :1]
    a_t, b_t = torch.tensor(a).to(tdt).cuda(), torch.tensor(b).to(tdt).cuda()
    before = linear_scan_kernel.launches
    h, h_last = linear_scan(a_t, b_t)
    torch.cuda.synchronize()
    assert linear_scan_kernel.launches == before + 1
    want, want_last = linear_scan_ref(a_t, b_t)
    _assert_close(h.cpu(), want.cpu(), tol)
    _assert_close(h_last.cpu(), want_last.cpu(), tol)
