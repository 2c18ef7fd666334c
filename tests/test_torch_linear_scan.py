"""The port's linear recurrence and fold prefix against the JAX package's.

On the CPU the port's dispatcher runs its plain PyTorch version; it is
held against the JAX plain version and against the JAX Pallas kernel in
interpret mode, on the shape x dtype grid of ``tests/test_kernels.py``,
and the port's ``fold_prefix`` against the JAX one.  Under grad the
recurrence goes through ``LinearScan``: its plain reverse loop
(``linear_scan_backward_ref``) is held bit for bit against autograd of
the plain forward loop, the Function against ``gradcheck`` in fp64 and
against ``jax.grad`` of the JAX package's ``linear_scan_ref`` and
``chunked_linear_scan``.  The CUDA forward kernel is checked on the card
(``cuda`` marker; skipped where there is none); the backward kernel in
``tests/test_torch_train_card.py``, which runs without JAX.  Inputs come
from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.linear_scan.ops import (  # noqa: E402
    fold_prefix as jax_fold_prefix, linear_scan as jax_linear_scan)
from repro.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_ref as jax_linear_scan_ref)
from repro.models.scan_utils import chunked_linear_scan  # noqa: E402
from repro_torch.kernels.linear_scan import ops  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_backward_kernel, linear_scan_kernel)
from repro_torch.kernels.linear_scan.ops import (  # noqa: E402
    LinearScan, fold_prefix, linear_scan)
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_backward_ref, linear_scan_ref)

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


# ---------------------------------------------------------------------------
# the backward: the reverse recurrence under LinearScan
# ---------------------------------------------------------------------------

def _grad_inputs(shape, seed=5):
    """a in (0.5, 0.999), b, and the upstream gradients dh (of h) and
    dh_last (of h_last), fp32 numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    b, dh = (rng.standard_normal(shape).astype(np.float32) for _ in "bd")
    dh_last = rng.standard_normal(shape[:1] + shape[2:]).astype(np.float32)
    return a, b, dh, dh_last


def _torch_grads(scan, a, b, dh, dh_last, with_last):
    """(da, db) of <h, dh> (+ <h_last, dh_last>) through ``scan``."""
    a_t = torch.tensor(a, requires_grad=True)
    b_t = torch.tensor(b, requires_grad=True)
    h, h_last = scan(a_t, b_t)
    loss = (h * torch.tensor(dh)).sum()
    if with_last:
        loss = loss + (h_last * torch.tensor(dh_last)).sum()
    return torch.autograd.grad(loss, [a_t, b_t])


@pytest.mark.parametrize("S", [1, 3, 8, 13])
@pytest.mark.parametrize("with_last", [False, True])
def test_backward_ref_is_autograd_of_the_plain_loop(S, with_last):
    """Bit for bit in fp32: the plain reverse loop rounds each product and
    sum as autograd of the plain forward loop does; LinearScan's CPU
    backward is that loop; h_last's gradient seeds the last step."""
    a, b, dh, dh_last = _grad_inputs((2, S, 5))
    want = _torch_grads(linear_scan_ref, a, b, dh, dh_last, with_last)
    h, _ = linear_scan_ref(torch.tensor(a), torch.tensor(b))
    got = linear_scan_backward_ref(
        torch.tensor(a), h, torch.tensor(dh),
        torch.tensor(dh_last) if with_last else None)
    fn = _torch_grads(linear_scan, a, b, dh, dh_last, with_last)
    for w, g, f in zip(want, got, fn):
        assert g.dtype == torch.float32
        assert torch.equal(g, w) and torch.equal(f, w)


@pytest.mark.parametrize("outputs", ["h", "h_last", "both"])
def test_linear_scan_gradcheck_fp64(outputs):
    """The Function's analytic gradients against finite differences, in
    fp64 (the plain versions compute in fp64 for fp64 inputs); a gradient
    of an unused output arrives as None and counts as zero."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.uniform(0.5, 0.999, (2, 6, 3)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((2, 6, 3)), requires_grad=True)
    pick = {"h": lambda h, hl: h, "h_last": lambda h, hl: hl,
            "both": lambda h, hl: (h, hl)}[outputs]
    assert torch.autograd.gradcheck(
        lambda x, y: pick(*LinearScan.apply(x, y, False)), (a, b))


@pytest.mark.parametrize("jax_scan", ["linear_scan_ref",
                                      "chunked_linear_scan"])
@pytest.mark.parametrize("shape", [(2, 64, 6), (2, 48, 4, 3)])
def test_gradients_match_jax_grad(jax_scan, shape):
    """``linear_scan``'s gradients against ``jax.grad`` of the JAX
    package's plain scan and of its chunked XLA scan (chunks of 16: four
    carries across chunks), on the flat and on Mamba's (B, S, d, N)
    layout: 1e-6 per unit of the largest magnitude (the chunked scan sums
    in another order)."""
    a, b, dh, dh_last = _grad_inputs(shape)
    fn = {"linear_scan_ref": lambda x, y: jax_linear_scan_ref(
              x.reshape(x.shape[:2] + (-1,)), y.reshape(y.shape[:2] + (-1,))),
          "chunked_linear_scan": lambda x, y: chunked_linear_scan(
              x, y, chunk=16)}[jax_scan]

    def loss(x, y):
        h, h_last = fn(x, y)
        return (jnp.sum(h.reshape(dh.shape) * dh)
                + jnp.sum(h_last.reshape(dh_last.shape) * dh_last))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    got = _torch_grads(linear_scan, a, b, dh, dh_last, True)
    for g, w in zip(got, want):
        _assert_close(g, w, 1e-6)


def test_no_grad_and_grad_free_inputs_take_the_forward_alone():
    """Serving and the fold: no autograd node, nothing saved."""
    a, b = _inputs((1, 8, 4))
    a_t, b_t = torch.tensor(a, requires_grad=True), torch.tensor(b)
    with torch.no_grad():
        h, _ = linear_scan(a_t, b_t)
    assert h.grad_fn is None
    h, _ = linear_scan(a_t.detach(), b_t)
    assert h.grad_fn is None
    h, _ = linear_scan(a_t, b_t)
    assert type(h.grad_fn.next_functions[0][0]).__name__ == \
        "LinearScanBackward"


def test_grad_refuses_a_broadcast_a_bf16_and_a_kernel_forced_on_cpu():
    a, b = _inputs((1, 8, 4))
    a1 = torch.tensor(a[:, :, :1], requires_grad=True)
    with pytest.raises(ValueError, match="LinearScan differentiates a full "
                       r"\(B, S, C\) a only"):
        linear_scan(a1, torch.tensor(b))
    with pytest.raises(TypeError, match="no bfloat16 backward"):
        linear_scan(torch.tensor(a, dtype=torch.bfloat16,
                                 requires_grad=True),
                    torch.tensor(b, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contradicts"):
        linear_scan(torch.tensor(a, requires_grad=True), torch.tensor(b),
                    use_kernel=True)


def test_backward_kernel_wrapper_refuses():
    """By name, before any launch: bf16, a broadcast a, CPU tensors."""
    before = linear_scan_backward_kernel.launches
    a, b = _inputs((1, 8, 4))
    t = torch.tensor(b)
    with pytest.raises(ValueError, match="takes float32 only"):
        linear_scan_backward_kernel(t.bfloat16(), t.bfloat16(), t.bfloat16())
    with pytest.raises(ValueError, match=r"full \(B, S, C\) a \(not a "
                       "broadcast"):
        linear_scan_backward_kernel(torch.tensor(a[:, :, :1]), t, t)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        linear_scan_backward_kernel(torch.tensor(a), t, t, t[:, 0])
    assert linear_scan_backward_kernel.launches == before


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

