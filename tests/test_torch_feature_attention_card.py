"""K1's per-row feature pass on the CUDA card (every case carries the
``cuda`` marker and skips without a card; this file imports no JAX, so it
runs where the port runs).

``feature_attention_kernel`` against its plain version
(``feature_attention_ref``), within ``TOL`` per unit of the output's
largest magnitude (at least 1), on each of its routes, as
``feature_attention_plan`` reports them:

* the vector route (16-byte accesses), one warp a row, masks compiled
  away: Qwen2-0.5B's 896 fp32 columns; bf16 at 896 (masked);
* the vector route with a group of warps a row: 2048 (2 warps), 4096 (4)
  and 8192 (8) fp32 columns;
* the scalar route (masked element accesses, at most 16 values a lane):
  cols 1, 3, 33 and 1025 (four warps a row), bf16 with odd cols, and an
  unaligned ``data_ptr`` (a contiguous view with a storage offset; two
  warps a row);
* the wide route (a block a row: above 8192 columns on the vector route,
  4096 on the scalar);

and on edge rows on each route: a zero row, tiny rows (|w| ~ 1e-20,
whose output norm takes the 1e-12 clamp; held per row, relative to the
row's own largest output), one-hot rows at |w| ~ 80, and rows holding an
inf or a NaN (NaN where the plain version has NaN).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.feature_attention.kernel import (  # noqa: E402
    feature_attention_kernel, feature_attention_plan)
from repro_torch.kernels.feature_attention.ops import (  # noqa: E402
    feature_attention)
from repro_torch.kernels.feature_attention.ref import (  # noqa: E402
    feature_attention_ref)

SHAPES = [(8, 32), (100, 33), (9, 129), (257, 64), (3, 3, 1, 16),
          (2, 64, 128)]
DTYPES = {"float32": (torch.float32, 1e-6),
          "bfloat16": (torch.bfloat16, 2e-2)}
# (name, rows, cols, dtype, storage offset in elements) -> the expected
# (route, warps a row, masks compiled away)
ROUTES = {
    "narrow_aligned": ((64, 896, "float32", 0), ("vector", 1, True)),
    "narrow_bf16": ((64, 896, "bfloat16", 0), ("vector", 1, False)),
    "group_2048": ((32, 2048, "float32", 0), ("vector", 2, True)),
    "group_4096": ((16, 4096, "float32", 0), ("vector", 4, True)),
    "group_8192": ((8, 8192, "float32", 0), ("vector", 8, True)),
    "cols_1": ((40, 1, "float32", 0), ("scalar", 1, False)),
    "cols_3": ((40, 3, "float32", 0), ("scalar", 1, False)),
    "cols_33": ((40, 33, "float32", 0), ("scalar", 1, False)),
    "cols_1025": ((20, 1025, "float32", 0), ("scalar", 4, False)),
    "bf16_odd": ((37, 129, "bfloat16", 0), ("scalar", 1, False)),
    "unaligned": ((64, 896, "float32", 1), ("scalar", 2, False)),
    "too_wide": ((4, 8193, "float32", 0), ("wide", 8, False)),
    "too_wide_bf16": ((3, 10000, "bfloat16", 0), ("wide", 8, False)),
}
# tiny rows: |w| ~ 1e-20, far below the 1e-12 clamp on ||e w||
TINY = 1e-20


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _matrix(rows, cols, dtype, offset, edges=False, seed=0):
    """(rows, cols) on the card, ``offset`` elements into its storage.
    With ``edges`` its first rows are a zero row, a tiny row, a one-hot
    row at 80, a row holding an inf and a row holding a NaN."""
    x = np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)
    if edges:
        x[0] = 0.0
        x[1] *= TINY
        x[2] *= 0.01
        x[2, cols // 2] = -80.0
        x[3, cols - 1] = np.inf
        x[4, 0] = np.nan
    flat = torch.empty(offset + rows * cols, dtype=getattr(torch, dtype),
                       device="cuda")
    w = flat[offset:].view(rows, cols)
    w.copy_(torch.tensor(x))
    return w


def _check(got, want, tol, per_row=()):
    """NaN exactly where the plain version has NaN; elsewhere within tol
    per unit of the output's largest finite magnitude (at least 1), and
    the rows in ``per_row`` within tol of their own largest magnitude."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    bound = tol * max(1.0, float(want[fin].abs().max())
                      if fin.any() else 0.0)
    assert err < bound, f"max abs err {err} >= {bound}"
    for r in per_row:
        err = float((got[r] - want[r]).abs().max())
        bound = tol * float(want[r].abs().max())
        assert err <= bound, f"row {r}: max abs err {err} > {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(8, 256), (4096, 1024)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("normalize", [True, False])
def test_cuda_kernel_matches_plain_version(shape, dtype, normalize):
    _card()
    tdt, tol = DTYPES[dtype]
    w = torch.tensor(_inputs(shape)).to(tdt).cuda()
    before = feature_attention_kernel.launches
    got = feature_attention(w, normalize=normalize)
    torch.cuda.synchronize()
    assert feature_attention_kernel.launches == before + 1
    want = feature_attention_ref(w.reshape(-1, shape[-1]),
                                 normalize).reshape(shape)
    err = float((got.float() - want.float()).abs().max())
    # per unit of the output's largest magnitude, as the CPU tests and
    # chip_smoke.py's TOL: normalized rows reach |out| of 8-32, where one
    # fp32 ulp is 1e-6 to 4e-6 and the two sum each row in another order
    bound = tol * max(1.0, float(want.float().abs().max()))
    assert got.dtype == tdt and err < bound, f"max abs err {err} >= {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUTES))
@pytest.mark.parametrize("normalize", [True, False])
def test_kernel_routes_match_plain_version(case, normalize):
    _card()
    (rows, cols, dtype, offset), (route, warps, unmasked) = ROUTES[case]
    w = _matrix(rows, cols, dtype, offset)
    assert w.is_contiguous() and (w.data_ptr() % 16 != 0) == (offset > 0)
    plan = feature_attention_plan(w)
    assert (plan["route"], plan["warps_per_row"], plan["unmasked"]) == (
        route, warps, unmasked)
    assert plan["local_bytes"] == 0  # no spill
    before = feature_attention_kernel.launches
    got = feature_attention_kernel(w, normalize)
    want = feature_attention_ref(w, normalize)
    torch.cuda.synchronize()
    assert feature_attention_kernel.launches == before + 1
    assert got.dtype == w.dtype and got.shape == w.shape
    _check(got, want, DTYPES[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow_aligned", "narrow_bf16",
                                  "group_4096", "cols_33", "cols_1025",
                                  "bf16_odd", "unaligned", "too_wide"])
@pytest.mark.parametrize("normalize", [True, False])
def test_kernel_edge_rows_match_plain_version(case, normalize):
    """Zero, tiny (the clamp), one-hot and inf / NaN rows on each route;
    the tiny row held relative to its own magnitude."""
    _card()
    (rows, cols, dtype, offset), _ = ROUTES[case]
    w = _matrix(max(rows, 6), cols, dtype, offset, edges=True)
    got = feature_attention_kernel(w, normalize)
    want = feature_attention_ref(w, normalize)
    torch.cuda.synchronize()
    # the plain version's own rows: 0 stays 0, the NaN rows are NaN
    assert float(want[0].abs().max()) == 0.0
    assert bool(torch.isnan(want[3]).all() and torch.isnan(want[4]).all())
    if normalize:  # the tiny row's ||e w|| took the clamp
        a = w[1].float().abs()
        e = torch.exp(a - a.max())
        assert float((e / e.sum() * w[1].float()).norm()) < 1e-12
    _check(got, want, DTYPES[dtype][1], per_row=(0, 1, 2))
