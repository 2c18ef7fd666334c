"""The fused selective-scan kernel on the CUDA card (every case carries the
``cuda`` marker and skips without a card; this file imports no JAX, so
it runs where the port runs).

* ``selective_scan_kernel`` bit for bit against its plain version
  (``selective_scan_ref``: y and h_last; both round every product and sum
  alone, exp included, and sum y over n in order) at Falcon-Mamba-7B's
  width (d_inner 8192, N 16) in bf16 and fp32, at S not a multiple of the
  kernel's 8-step stage, at one step and at a d_inner that is not a
  multiple of its 128-channel block;
* reduced Falcon-Mamba-7B's prefill launches it once a layer and K2 not
  at all, its decode neither, and the prefill matches the CPU's;
* the wrapper's refusals on the card (grad, N, d_inner, contiguity, a
  CPU tensor among CUDA ones);
* the backward kernel (``selective_scan_backward_kernel``) against its
  plain version (``selective_scan_backward_ref``) at two chunks of 256
  steps, and at the edges of its 8-step stages and 32-channel blocks: 65
  chunks of 8 (one stage) and one chunk of 100 (its last stage 4 steps)
  at a d_inner that is not a multiple of the block, 65 chunks of 4
  (shorter than a stage), 3 blocks (far below one wave of them) and one
  step, with and without a gradient of h_last: dxh, ddt and dA bit for
  bit (both round every product and sum alone, sum over n in the
  kernel's lane order and dA over the steps in the walk's order),
  dbc (a sum over channels, in another order) within ``BWD_TOL`` per
  unit of its largest magnitude; the forward's chunk states bit for bit;
  then through
  ``ops.selective_scan``'s autograd Function, one forward and one
  backward launch and the same gradients;
* the backward's refusals: bf16 under grad, N other than 16, a CPU
  tensor.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_kernel, selective_scan_backward_kernel,
    selective_scan_kernel)
from repro_torch.kernels.linear_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    selective_scan_backward_ref, selective_scan_ref)
from repro_torch.models import build_model  # noqa: E402

# (B, S, d_inner, N)
SHAPES = [(2, 64, 8192, 16), (2, 13, 256, 16), (3, 37, 136, 16),
          (2, 1, 128, 16), (1, 40, 200, 16)]
TOL = 5e-4  # the prefill's logits card vs CPU, tests/test_torch_ssm.py's
# the backward's cases (B, S, d_inner, N): two chunks of 256, 65 chunks of
# 8 at a ragged d_inner, 65 chunks of 4, one chunk of 100 at a ragged
# d_inner, 3 blocks of 32 channels, one step
BWD_SHAPES = [(2, 512, 256, 16), (2, 520, 200, 16), (2, 260, 136, 16),
              (3, 100, 200, 16), (1, 24, 72, 16), (1, 1, 128, 16)]
# dbc against the plain version: sums over channels in another order;
# max abs error per unit of the largest magnitude
BWD_TOL = 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")


def _inputs(shape, dtype, seed=0):
    B, S, di, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    xh = torch.nn.functional.silu(torch.randn(
        (B, S, di), generator=g, device="cuda")).to(dtype)
    b_dt = torch.rand(di, generator=g, device="cuda") * 8.0 - 4.0
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=g, device="cuda") * 0.5 + b_dt)
    A = -torch.exp(torch.rand((di, N), generator=g, device="cuda") * 2 - 1)
    bc = torch.randn((B, S, 2 * N), generator=g, device="cuda").to(dtype)
    return xh, dt, A, bc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_is_its_plain_version_bit_for_bit(shape, dtype):
    _card()
    ins = _inputs(shape, getattr(torch, dtype))
    before = selective_scan_kernel.launches
    y, h_last = selective_scan_kernel(*ins)
    want_y, want_last = selective_scan_ref(*ins)
    torch.cuda.synchronize()
    assert selective_scan_kernel.launches == before + 1
    assert y.dtype == h_last.dtype == torch.float32
    assert torch.equal(h_last, want_last)
    assert torch.equal(y, want_y)


@pytest.mark.cuda
def test_reduced_prefill_launches_fused_scan_once_per_layer():
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("falcon-mamba-7b").reduced()
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    pc = tree_map(lambda t: t.to("cuda"), p)
    k2, ss = linear_scan_kernel.launches, selective_scan_kernel.launches
    with torch.no_grad():
        lg, cache = model.prefill(pc, {"tokens": toks.cuda()})
        assert selective_scan_kernel.launches - ss == cfg.n_layers
        model.decode_step(pc, cache, toks[:, :1].cuda(),
                          torch.full((2,), 48, dtype=torch.int32,
                                     device="cuda"))
        want, _ = model.prefill(p, {"tokens": toks})
    assert selective_scan_kernel.launches - ss == cfg.n_layers
    assert linear_scan_kernel.launches == k2
    err = float((lg.cpu() - want).abs().max()) / float(want.abs().max())
    assert err < TOL


@pytest.mark.cuda
def test_wrapper_refusals_on_the_card():
    _card()
    xh, dt, A, bc = _inputs((2, 8, 64, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no autograd history"):
        selective_scan_kernel(xh, dt.clone().requires_grad_(), A, bc)
    with pytest.raises(ValueError, match="N = 16"):
        selective_scan_kernel(xh, dt, A[:, :8].contiguous(), bc[..., :16])
    with pytest.raises(ValueError, match="multiple of 8"):
        selective_scan_kernel(xh[..., :60].contiguous(),
                              dt[..., :60].contiguous(), A[:60], bc)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_kernel(xh.transpose(0, 1), dt.transpose(0, 1), A,
                              bc.transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_kernel(xh, dt, A, bc.cpu())


def _per_unit(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernel_matches_its_plain_version(shape, with_last):
    _card()
    B, S, di, N = shape
    ins = _inputs(shape, torch.float32, seed=3)
    g = torch.Generator(device="cuda").manual_seed(4)
    gy = torch.randn((B, S, di), generator=g, device="cuda")
    gl = (torch.randn((B, di, N), generator=g, device="cuda") if with_last
          else None)
    y, h_last, chunks = selective_scan_kernel(*ins, chunks=True)
    want_y, want_last, want_chunks = selective_scan_ref(*ins, chunks=True)
    assert torch.equal(chunks, want_chunks)
    assert torch.equal(y, want_y) and torch.equal(h_last, want_last)
    before = selective_scan_backward_kernel.launches
    got = selective_scan_backward_kernel(*ins, chunks, gy, gl)
    want = selective_scan_backward_ref(*ins, chunks, gy, gl)
    torch.cuda.synchronize()
    assert selective_scan_backward_kernel.launches == before + 1
    assert torch.equal(got[0], want[0])  # dxh
    assert torch.equal(got[1], want[1])  # ddt
    assert torch.equal(got[2], want[2])  # dA
    if S == 1:  # at one step the gradient of A is 0 (h_{-1} = 0)
        assert not got[2].any()
    assert _per_unit(got[3], want[3]) <= BWD_TOL
    # through ops.selective_scan's autograd Function
    leaves = [t.clone().requires_grad_() for t in ins]
    fwd, k2 = selective_scan_kernel.launches, linear_scan_kernel.launches
    y2, h2 = selective_scan(*leaves)
    loss = (y2 * gy).sum() + ((h2 * gl).sum() if with_last else 0)
    fn = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert selective_scan_kernel.launches == fwd + 1
    assert selective_scan_backward_kernel.launches == before + 2
    assert linear_scan_kernel.launches == k2
    assert torch.equal(y2, y) and torch.equal(h2, h_last)
    for f, w in zip(fn, got):
        assert torch.equal(f, w)


@pytest.mark.cuda
def test_backward_refusals_on_the_card():
    _card()
    xh, dt, A, bc = _inputs((2, 8, 64, 16), torch.float32)
    _, _, chunks = selective_scan_kernel(xh, dt, A, bc, chunks=True)
    gy = torch.ones_like(dt)
    with pytest.raises(TypeError, match="no bfloat16 backward"):
        selective_scan(xh.to(torch.bfloat16).requires_grad_(), dt, A,
                       bc.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32 only"):
        selective_scan_backward_kernel(xh.to(torch.bfloat16), dt, A,
                                       bc.to(torch.bfloat16), chunks, gy)
    with pytest.raises(ValueError, match="N = 16"):
        selective_scan_backward_kernel(
            xh, dt, A[:, :8].contiguous(), bc[..., :16].contiguous(),
            chunks[..., :8].contiguous(), gy)
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_backward_kernel(xh, dt, A, bc, chunks, gy.cpu())
    with pytest.raises(ValueError, match="h_chunks"):
        selective_scan_backward_kernel(xh, dt, A, bc, chunks[:, :0], gy)
