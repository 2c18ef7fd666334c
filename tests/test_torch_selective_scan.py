"""The fused selective scan's plain version against the JAX package.

``repro_torch.kernels.linear_scan.ref.selective_scan_ref`` is the plain
version of the fused selective-scan kernel (K2's redesign on the Mamba
prefill): a PyTorch port of ``repro.models.ssm._fused_chunk_scan``, the
JAX package's default Mamba scan (``scan_impl="xla"``).  On the CPU it
is held against that function across its chunk boundaries (S = 48, 384
and 512 cross one, three and two chunks of JAX's rule), against the
port's own K2 route (``_ssm_coeffs``, ``linear_scan_ref``, the einsum
with C), and ``mamba_forward`` is checked to take the fused dispatcher
with and without grad (under grad through ``SelectiveScan``, whose CPU
backward is ``selective_scan_backward_ref``).  That plain backward is
held against ``torch.autograd`` through ``selective_scan_ref`` at S = 1,
24, 256, 512 (two chunks of 256) and 520 (65 chunks of 8), with and
without a gradient of h_last, in fp64 and fp32.  The dispatcher's and the
wrappers' refusals are checked on CPU tensors; the kernels themselves are
held against their plain versions on the card in
``tests/test_torch_selective_scan_card.py``.  Inputs come from numpy
with a seed; the weights are a Mamba layer's as the JAX spec draws them.

Tolerances, per unit of the reference's largest magnitude: against JAX
in fp32 ``TOL`` = 1e-5 (measured at most 6.5e-7 on y and 3.1e-7 on
h_last: XLA's associative scan inside a chunk and its einsum round in
another order); with bf16 weights and xh ``BF16_TOL`` = 5e-4 (the
products of xh by the dt and B/C weights round to bf16 in each
framework; measured at most 2.5e-5 on y, 2.6e-7 on h_last); against the
K2 route h_last bit for bit and y within ``ROUTE_TOL`` = 1e-6 (the
einsum's order against the ordered sum over n; measured at most
1.4e-7); the layer against the JAX layer at ``tests/test_torch_ssm.py``'s
``TOL``, 5e-4.  The plain backward against autograd of the plain
forward: in fp64 within ``GRAD64_TOL`` = 1e-12 (measured at most 4.4e-16:
the sums over n, d and t in other orders), in fp32 within ``TOL``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    selective_scan_backward_kernel, selective_scan_kernel)
from repro_torch.kernels.linear_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    fused_chunk, linear_scan_ref, selective_scan_backward_ref,
    selective_scan_ref)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

N, R = 16, 16
TOL = 1e-5
BF16_TOL = 5e-4
ROUTE_TOL = 1e-6
LAYER_TOL = 5e-4
GRAD64_TOL = 1e-12
# the backward's sequence lengths: one step, one chunk of 24, one of 256,
# two of 256, 65 of 8
BWD_S = [1, 24, 256, 512, 520]
# (S, d_inner): one, three and two chunks of JAX's rule (48; 384 -> 128;
# 512 -> 256)
CASES = [(48, 64), (384, 128), (512, 512)]


def _params(di, seed=0):
    """A Mamba layer's scan weights as the JAX spec draws them: fan_in
    normals, b_dt ~ U(-4, 4), A_log ~ U(-1, 1)."""
    rng = np.random.default_rng(seed)
    return {"w_x_dt": rng.standard_normal((di, R)) / np.sqrt(di),
            "w_x_bc": rng.standard_normal((di, 2 * N)) / np.sqrt(di),
            "w_dt": rng.standard_normal((R, di)) / np.sqrt(R),
            "b_dt": rng.uniform(-4.0, 4.0, di),
            "A_log": rng.uniform(-1.0, 1.0, (di, N))}


def _xh(B, S, di, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, di))
    return x / (1.0 + np.exp(-x))  # silu, as the layer's conv output


def _both(p, xh, dtype):
    """(JAX params and xh, port params and xh) in ``dtype``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = {k: jnp.asarray(v, jnp.float32).astype(jdt) for k, v in p.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32).to(tdt)
          for k, v in p.items()}
    return (jp, jnp.asarray(xh, jnp.float32).astype(jdt), tp,
            torch.tensor(xh, dtype=torch.float32).to(tdt))


def _rel(got, want) -> float:
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(jnp.asarray(got, jnp.float32))
    want = want.to(torch.float32).numpy() if isinstance(
        want, torch.Tensor) else np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-6)


def test_fused_chunk_is_jax_rule():
    """min(256, S), halved until it divides S: the chunks of the cases
    and of the served prompt (2016 -> 32)."""
    for S, c in ((48, 48), (384, 128), (512, 256), (2016, 32), (1, 1),
                 (7, 7), (300, 4)):
        assert fused_chunk(S) == c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,di", CASES)
def test_ref_matches_jax_fused_chunk_scan(S, di, dtype):
    B = 2
    jp, jx, tp, tx = _both(_params(di), _xh(B, S, di), dtype)
    want_y, want_h = jssm._fused_chunk_scan(jp, jx)
    dt, A, bc = ssm._scan_inputs(tp, tx)
    y, h_last = selective_scan_ref(tx, dt, A, bc)
    assert y.dtype == h_last.dtype == torch.float32
    assert tuple(y.shape) == (B, S, di) and tuple(h_last.shape) == (B, di, N)
    tol = TOL if dtype == "float32" else BF16_TOL
    assert _rel(y, want_y) < tol
    assert _rel(h_last, want_h) < tol
    # the dispatcher sends a CPU tensor to the plain version
    y2, h2 = selective_scan(tx, dt, A, bc)
    assert torch.equal(y2, y) and torch.equal(h2, h_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,di", CASES)
def test_ref_matches_k2_route(S, di, dtype):
    """The port's K2 route: the (B, S, di, N) coefficients, the
    recurrence over them and the einsum with C.  The states are the same
    products and sums rounded the same way: h_last bit for bit."""
    B = 2
    _, _, tp, tx = _both(_params(di, seed=2), _xh(B, S, di, seed=3), dtype)
    dA, dBx, Cc = ssm._ssm_coeffs(tp, tx)
    h, h_last = linear_scan_ref(dA.reshape(B, S, -1), dBx.reshape(B, S, -1))
    want_y = torch.einsum("bsdn,bsn->bsd", h.reshape(B, S, di, N),
                          Cc.to(torch.float32))
    dt, A, bc = ssm._scan_inputs(tp, tx)
    y, got_last = selective_scan_ref(tx, dt, A, bc)
    assert torch.equal(got_last, h_last.reshape(B, di, N))
    assert _rel(y, want_y) < ROUTE_TOL


def _mamba_layer():
    jcfg = jax_get_arch("falcon-mamba-7b").reduced()
    jm = jax_build_model(jcfg, LOCAL)
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), w["blocks"]["mamba"])
    tp = layer(params_from_numpy(w, device="cpu")["blocks"], 0)["mamba"]
    return jcfg, jp, tp


def test_mamba_forward_without_grad_takes_the_fused_dispatcher(monkeypatch):
    """Without grad the layer's scan is one ``selective_scan`` call (JAX's
    default branch) and no K2 route; the output and state match the JAX
    layer under ``scan_impl="xla"``."""
    jcfg, jp, tp = _mamba_layer()
    cfg = get_arch("falcon-mamba-7b").reduced()
    calls = []

    def spy(*args, **kw):
        calls.append("selective_scan")
        return scan_ops.selective_scan(*args, **kw)

    monkeypatch.setattr(ssm, "selective_scan", spy)
    monkeypatch.setattr(scan_ops, "linear_scan_ref",
                        lambda *a, **k: pytest.fail("K2 route without grad"))
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, st = ssm.mamba_forward(tp, torch.tensor(x), cfg,
                                    return_state=True)
    assert calls == ["selective_scan"]
    want, jst = jssm.mamba_forward(jp, jnp.asarray(x), jcfg, LOCAL,
                                   return_state=True)
    assert _rel(out, want) < LAYER_TOL
    assert _rel(st["h"], jst["h"]) < LAYER_TOL


def test_mamba_forward_with_grad_takes_the_fused_scan(monkeypatch):
    """Under grad the scan is JAX's default branch too: one
    ``selective_scan`` call through ``SelectiveScan`` (its plain forward
    once, saving the chunk carries, and its plain backward once on the
    CPU), never the K2 route."""
    _, _, tp = _mamba_layer()
    cfg = get_arch("falcon-mamba-7b").reduced()
    monkeypatch.setattr(scan_ops, "linear_scan_ref",
                        lambda *a, **k: pytest.fail("K2 route under grad"))
    calls = []
    for name in ("selective_scan_ref", "selective_scan_backward_ref"):
        ref = getattr(scan_ops, name)

        def spy(*args, _ref=ref, _name=name, **kw):
            calls.append((_name, kw.get("chunks", False)))
            return _ref(*args, **kw)

        monkeypatch.setattr(scan_ops, name, spy)
    applied = []
    apply = scan_ops.SelectiveScan.apply

    def spy_apply(*args):
        applied.append(1)
        return apply(*args)

    monkeypatch.setattr(scan_ops.SelectiveScan, "apply", spy_apply)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    out = ssm.mamba_forward(leaves, x, cfg)
    out.sum().backward()
    assert applied == [1]
    assert calls == [("selective_scan_ref", True),
                     ("selective_scan_backward_ref", False)]
    assert all(v.grad is not None for v in leaves.values())


def _bwd_inputs(S, dtype, B=2, di=24, seed=0):
    """A Mamba scan's inputs (xh silu-like, dt after a softplus, A < 0)
    and the gradients of y and h_last, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di))
    xh = x / (1.0 + np.exp(-x))
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((B, S, di))
                         + rng.uniform(-4.0, 4.0, di)))
    A = -np.exp(rng.uniform(-1.0, 1.0, (di, N)))
    bc = rng.standard_normal((B, S, 2 * N))
    gy = rng.standard_normal((B, S, di))
    gl = rng.standard_normal((B, di, N))
    return [torch.tensor(v, dtype=dtype) for v in (xh, dt, A, bc, gy, gl)]


def _per_unit(got, want) -> float:
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("S", BWD_S)
def test_backward_ref_matches_autograd(S, with_last, dtype):
    """``selective_scan_backward_ref`` from the forward's chunk carries
    against ``torch.autograd`` through ``selective_scan_ref``: every
    gradient (xh, dt, A, bc) per unit of its largest magnitude; and
    ``ops.selective_scan`` under grad gives the plain backward's
    gradients bit for bit."""
    xh, dt, A, bc, gy, gl = _bwd_inputs(S, getattr(torch, dtype))
    gl = gl if with_last else None
    leaves = [t.clone().requires_grad_() for t in (xh, dt, A, bc)]
    y, h_last = selective_scan_ref(*leaves)
    loss = (y * gy).sum() + ((h_last * gl).sum() if with_last else 0)
    want = torch.autograd.grad(loss, leaves)
    _, _, chunks = selective_scan_ref(xh, dt, A, bc, chunks=True)
    c = fused_chunk(S)
    assert tuple(chunks.shape) == (2, S // c, 24, N)
    got = selective_scan_backward_ref(xh, dt, A, bc, chunks, gy, gl)
    tol = GRAD64_TOL if dtype == "float64" else TOL
    for name, g, w in zip(("xh", "dt", "A", "bc"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _per_unit(g, w) <= tol, (name, _per_unit(g, w))
    y2, h2 = selective_scan(*leaves)
    loss2 = (y2 * gy).sum() + ((h2 * gl).sum() if with_last else 0)
    for g, f in zip(got, torch.autograd.grad(loss2, leaves)):
        assert torch.equal(g, f)


def test_backward_sums_over_n_in_the_kernels_lane_order():
    """The plain backward sums dxh's and ddt's terms over n as the
    backward kernel's four threads a channel do: each thread a quarter of
    n in order, then ``(p0 + p2) + (p1 + p3)``, each sum rounded alone;
    on these fp32 rows that order and the in-order sum part.  Below 4
    states (no kernel runs those) it sums them in order."""
    from repro_torch.kernels.linear_scan import ref as scan_ref

    v = torch.tensor(np.random.default_rng(5).standard_normal((4096, N)),
                     dtype=torch.float32)
    p = [v[:, 4 * j] + v[:, 4 * j + 1] + v[:, 4 * j + 2] + v[:, 4 * j + 3]
         for j in range(4)]
    got = scan_ref._sum_over_n_lanes(v)
    assert torch.equal(got, (p[0] + p[2]) + (p[1] + p[3]))
    assert not torch.equal(got, scan_ref._sum_over_n(v))
    assert torch.equal(scan_ref._sum_over_n_lanes(v[:, :3]),
                       scan_ref._sum_over_n(v[:, :3]))


@pytest.mark.parametrize("S", [24, 520])
def test_backward_ref_in_lane_order_matches_fp64_autograd(S):
    """The fp32 plain backward, its sums over n in the kernel's lane
    order, against ``torch.autograd`` through ``selective_scan_ref`` in
    fp64 on the same inputs: every gradient within ``TOL`` per unit of
    its largest magnitude."""
    ins = _bwd_inputs(S, torch.float64)
    leaves = [t.clone().requires_grad_() for t in ins[:4]]
    y, h_last = selective_scan_ref(*leaves)
    want = torch.autograd.grad(
        (y * ins[4]).sum() + (h_last * ins[5]).sum(), leaves)
    xh, dt, A, bc, gy, gl = (t.float() for t in ins)
    _, _, chunks = selective_scan_ref(xh, dt, A, bc, chunks=True)
    got = selective_scan_backward_ref(xh, dt, A, bc, chunks, gy, gl)
    for name, g, w in zip(("xh", "dt", "A", "bc"), got, want):
        assert g.dtype == torch.float32, name
        assert _per_unit(g.double(), w) <= TOL, (name, _per_unit(g.double(),
                                                                w))


def test_chip_smoke_backward_bound_is_the_functions_own_work(monkeypatch):
    """``chip_smoke.selective_backward_bound`` counts the function's own
    work, not a design's: at train_step_mamba_long's scan (8, 2048, 8192,
    16) 29 FP32-pipe instructions an element bind, 1.8590 ms (the SFU
    0.5128, the bytes 0.8141); and ``_ptxas_function`` reads the
    backward's registers, spills and static shared memory from a ptxas
    report."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    ms, by, detail = cs.selective_backward_bound(8, 2048, 8192, 16, 256)
    assert by == "operations" and detail["binds"] == "fp32_pipe"
    assert detail["per_element"] == {"fp32": 29, "ex2": 1}
    assert abs(ms - 1.8590) < 1e-3
    assert abs(detail["sfu_ms"] - 0.5128) < 1e-3
    assert abs(detail["bytes_ms"] - 0.8141) < 1e-3
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118selective_scan_fwdIfLb0EEEvPKT_' for 'sm_90a'
ptxas info    : Used 72 registers, 12288 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118selective_scan_bwdEPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118selective_scan_bwdEPKfS1_
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 120 registers, 432 bytes cmem[0]
"""
    assert cs._ptxas_function(log, "selective_scan_bwd") == {
        "spill_stores": 4, "spill_loads": 8, "registers": 120,
        "static_smem_bytes": 0}
    assert cs._ptxas_function(log, "selective_scan_fwdIfLb0E") == {
        "registers": 72, "static_smem_bytes": 12288}


def test_chunk_carries_are_the_states_before_each_chunk():
    """``h_chunks[:, k]`` is the state after k c steps: zero, then the
    h_last of the scan cut after each chunk (65 chunks of 8 at S = 520)."""
    xh, dt, A, bc, _, _ = _bwd_inputs(520, torch.float32)
    y, h_last, chunks = selective_scan_ref(xh, dt, A, bc, chunks=True)
    assert torch.equal(selective_scan_ref(xh, dt, A, bc)[1], h_last)
    assert not chunks[:, 0].any()
    for k in (1, 2, 64):
        cut = [t[:, :8 * k] for t in (xh, dt, bc)]
        want = selective_scan_ref(cut[0], cut[1], A, cut[2])[1]
        # a shorter scan has another chunk (8 k steps in chunks of
        # fused_chunk(8 k)): the same recurrence in order, bit for bit
        assert torch.equal(chunks[:, k], want), k


def _small(dtype=torch.float32, B=2, S=8, di=16):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((B, S, di), generator=g).to(dtype),
            torch.rand((B, S, di), generator=g),
            -torch.rand((di, N), generator=g),
            torch.randn((B, S, 2 * N), generator=g).to(dtype))


def test_dispatcher_refuses_kernel_on_cpu():
    xh, dt, A, bc = _small()
    with pytest.raises(ValueError, match="use_kernel=True"):
        selective_scan(xh, dt, A, bc, use_kernel=True)
    y, _ = selective_scan(xh, dt, A, bc, use_kernel=False)
    assert y.shape == xh.shape


def test_wrapper_refuses_cpu_tensors_and_grad():
    xh, dt, A, bc = _small()
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_kernel(xh, dt, A, bc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_backward_kernel(xh, dt, A, bc,
                                       torch.zeros((2, 1, 16, N)), dt)
    with pytest.raises(RuntimeError, match="no autograd history.*"
                       "ops.selective_scan"):
        selective_scan_kernel(xh, dt.requires_grad_(), A, bc)
    assert selective_scan_kernel.launches == 0
    assert selective_scan_backward_kernel.launches == 0


def test_dispatcher_refuses_bf16_under_grad():
    """No bfloat16 backward, as ``LinearScan``: under grad xh and bc must
    be fp32 (fp64 on the CPU); without grad bf16 goes through."""
    xh, dt, A, bc = _small(torch.bfloat16)
    with pytest.raises(TypeError, match="SelectiveScan.*no bfloat16 "
                       "backward"):
        selective_scan(xh, dt.requires_grad_(), A, bc)
    with torch.no_grad():
        y, _ = selective_scan(xh, dt, A, bc)
    assert y.dtype == torch.float32


@pytest.mark.parametrize("case", ["bc_dtype", "dt_dtype", "A_dtype"])
def test_refuses_mixed_dtypes(case):
    xh, dt, A, bc = _small(torch.bfloat16)
    if case == "bc_dtype":
        bc = bc.to(torch.float32)
    elif case == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    else:
        A = A.to(torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        selective_scan(xh, dt, A, bc)


@pytest.mark.parametrize("case", ["dt", "A_rows", "bc_width", "bc_rows",
                                  "xh_2d"])
def test_refuses_wrong_shapes(case):
    xh, dt, A, bc = _small()
    if case == "dt":
        dt = dt[:, :-1]
    elif case == "A_rows":
        A = A[:-1]
    elif case == "bc_width":
        bc = bc[..., :-2]
    elif case == "bc_rows":
        bc = bc[:, :-1]
    else:
        xh = xh[0]
    with pytest.raises(ValueError, match="shape"):
        selective_scan(xh, dt, A, bc)
