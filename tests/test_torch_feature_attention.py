"""The port's Eq. (5)-(6) feature pass against the JAX package's.

On the CPU the port's dispatcher runs its plain PyTorch version; it is
held against the JAX plain version and against the JAX Pallas kernel in
interpret mode, on the shape x dtype x normalize grid of
``tests/test_kernels.py``.  The CUDA kernel itself is checked on the
card (``cuda`` marker; skipped where there is none).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.feature_attention.ops import (  # noqa: E402
    feature_attention as jax_feature_attention)
from repro.kernels.feature_attention.ref import (  # noqa: E402
    feature_attention_ref as jax_feature_attention_ref)
from repro_torch.kernels.feature_attention.ops import (  # noqa: E402
    feature_attention)
from repro_torch.kernels.feature_attention.ref import (  # noqa: E402
    feature_attention_ref)

SHAPES = [(8, 32), (100, 33), (9, 129), (257, 64), (3, 3, 1, 16),
          (2, 64, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("normalize", [True, False])
def test_port_matches_jax_ref_and_pallas_interpret(shape, dtype, normalize):
    jdt, tdt, tol = DTYPES[dtype]
    x = _inputs(shape)
    w_t = torch.tensor(x).to(tdt)
    w_j = jnp.asarray(x).astype(jdt)
    # both frameworks round fp32 -> bf16 to nearest even: same inputs
    np.testing.assert_array_equal(_to_np32(w_t), _to_np32(w_j))
    got = feature_attention(w_t, normalize=normalize)
    assert got.dtype == tdt and tuple(got.shape) == shape
    want_ref = jax_feature_attention_ref(
        w_j.reshape(-1, shape[-1]), normalize=normalize).reshape(shape)
    want_kernel = jax_feature_attention(w_j, use_kernel=True, interpret=True,
                                        normalize=normalize)
    for want in (want_ref, want_kernel):
        want = _to_np32(want)
        err = np.max(np.abs(_to_np32(got) - want))
        # the two frameworks sum the row reductions in different orders,
        # so the fp32 rounding error scales with the output's magnitude
        # (normalized rows reach |w| of a few units): tol per unit of it
        bound = tol * max(1.0, float(np.max(np.abs(want))))
        assert err < bound, f"max abs err {err} >= {bound}"


def test_plain_version_preserves_row_norm():
    w = torch.tensor(_inputs((64, 256)))
    out = feature_attention_ref(w, normalize=True)
    assert float((w.norm(dim=-1) - out.norm(dim=-1)).abs().max()) < 1e-4


def test_literal_equation_shrinks_rows():
    w = torch.tensor(_inputs((32, 128)))
    out = feature_attention_ref(w, normalize=False)
    assert float(out.norm()) < float(w.norm())


@pytest.mark.parametrize("use_kernel", [None, False])
def test_cpu_tensor_takes_plain_version(use_kernel):
    w = torch.tensor(_inputs((8, 256)))
    got = feature_attention(w, use_kernel=use_kernel)
    assert torch.equal(got, feature_attention_ref(w))


def test_kernel_forced_on_cpu_raises():
    w = torch.tensor(_inputs((8, 256)))
    with pytest.raises(ValueError, match="feature_kernel=True"):
        feature_attention(w, use_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensor():
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)

    before = feature_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        feature_attention_kernel(torch.tensor(_inputs((8, 256))))
    assert feature_attention_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(8, 256), (4096, 1024)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("normalize", [True, False])
def test_cuda_kernel_matches_plain_version(shape, dtype, normalize):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)

    _, tdt, tol = DTYPES[dtype]
    w = torch.tensor(_inputs(shape)).to(tdt).cuda()
    before = feature_attention_kernel.launches
    got = feature_attention(w, normalize=normalize)
    torch.cuda.synchronize()
    assert feature_attention_kernel.launches == before + 1
    want = feature_attention_ref(w.reshape(-1, shape[-1]),
                                 normalize).reshape(shape)
    err = float((got.float() - want.float()).abs().max())
    assert got.dtype == tdt and err < tol
