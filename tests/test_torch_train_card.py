"""The training slice on the CUDA card (every case carries the ``cuda``
marker and skips without a card; this file imports no JAX, so it runs
where the port runs).

* K3's and K2's forward wrappers refuse CUDA inputs that require grad
  (K2's names ``ops.linear_scan``, its differentiable route);
* K2's backward kernel bit for bit against its plain reverse loop, S a
  multiple of its unroll or not, alone and under ``ops.linear_scan``'s
  autograd Function;
* reduced Falcon-Mamba-7B's and RecurrentGemma-9B's loss and gradient on
  the card track the CPU's from the same weights and batch within
  ``RUN_TOL`` per unit (the test keeps the name it had when SSM and
  hybrid training raised on the card): an RG-LRU layer through K2 and its
  backward kernel once each, a Mamba layer through the fused selective
  scan and its backward kernel once each and K2 not at all; a Mamba
  layer's gradient on the card (the fused scan's backward recomputing
  its chunk's states, JAX's checkpointed chunk body) tracks the CPU's;
* reduced Qwen2-0.5B trains through ``repro_torch.launch.train.train``
  on the card with one per-row K1 launch a fold and no K3 (the loss
  takes the plain attention), and tracks the CPU run from the same
  weights and streams (fp32, TF32 off) within ``RUN_TOL`` per unit of
  the CPU's largest magnitude, both sides' attention wq and wk scaled by
  ``COOL`` (as in ``tests/test_torch_train.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common.pytree import (  # noqa: E402
    tree_flatten_with_path, tree_map)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.kernels.feature_attention.kernel import (  # noqa: E402
    feature_attention_kernel)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_backward_kernel, linear_scan_kernel,
    selective_scan_backward_kernel, selective_scan_kernel)
from repro_torch.kernels.linear_scan.ops import linear_scan  # noqa: E402
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_backward_ref)
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.models import build_model, make_batch, ssm  # noqa: E402

COOL = 0.125
RUN_TOL = 1e-4
LOOP = dict(steps=8, batch=2, seq=32, eta=3e-3, lam=0.1, beta=0.001,
            seed=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cooled(w):
    if not isinstance(w, dict):
        return w
    return {k: (v * COOL if k in ("wq", "wk") and not isinstance(v, dict)
                else _cooled(v)) for k, v in w.items()}


@pytest.mark.cuda
def test_k3_and_k2_refuse_card_inputs_that_require_grad():
    _card()
    q = torch.zeros((1, 64, 1, 1, 64), device="cuda", requires_grad=True)
    k = torch.zeros((1, 64, 1, 64), device="cuda")
    pos = torch.arange(64, dtype=torch.int32, device="cuda")[None]
    with pytest.raises(RuntimeError, match="flash_attention_kernel has no "
                       "backward"):
        flash_attention_kernel(q, k, k, pos, pos, causal=True, window=0,
                               contiguous=True)
    b = torch.zeros((1, 8, 16), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="linear_scan_kernel returns "
                       "states with no autograd history.*ops.linear_scan"):
        linear_scan_kernel(b.detach(), b)


def _counts():
    """(K2, K2 backward, fused scan, fused backward) launches so far."""
    return (linear_scan_kernel.launches, linear_scan_backward_kernel.launches,
            selective_scan_kernel.launches,
            selective_scan_backward_kernel.launches)


def _loss_and_grads(model, params, batch):
    q = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(q, batch)
    grads = torch.autograd.grad(loss, [t for _, t in
                                       tree_flatten_with_path(q)])
    return float(loss), grads


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_ssm_and_hybrid_loss_on_the_card_raises(arch):
    """No longer raises: the gradient on the card tracks the CPU's (the
    attention cooled): once a recurrent layer K2 and its backward
    (RG-LRU), or the fused scan and its backward (Mamba)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tm = build_model(get_arch(arch).reduced())
    p = _cooled(tm.init(torch.Generator().manual_seed(0), device="cpu"))
    batch = make_batch(tm.cfg, 2, 24, seed=1, device="cpu")
    before = _counts()
    card_loss, card = _loss_and_grads(
        tm, tree_map(lambda t: t.to("cuda"), p),
        {k: v.to("cuda") for k, v in batch.items()})
    torch.cuda.synchronize()
    layers = (tm.cfg.n_layers if tm.cfg.family == "ssm"
              else 2 * (tm.cfg.n_layers // 3) + tm.cfg.n_layers % 3)
    want = ((0, 0, layers, layers) if tm.cfg.family == "ssm"
            else (layers, layers, 0, 0))
    assert tuple(a - b for a, b in zip(_counts(), before)) == want
    cpu_loss, cpu = _loss_and_grads(tm, p, batch)
    assert abs(card_loss - cpu_loss) <= RUN_TOL * max(abs(cpu_loss), 1.0)
    for (path, _), g, w in zip(tree_flatten_with_path(p), card, cpu):
        err = float((g.cpu() - w).abs().max())
        assert err <= RUN_TOL * max(float(w.abs().max()), 1.0), path


@pytest.mark.cuda
def test_mamba_layer_recompute_on_the_card():
    """A reduced Falcon-Mamba layer's gradient on the card at 2 x 40
    tokens: the fused scan once (saving its chunk carries) and its
    backward kernel once (recomputing the chunk's states), K2 not at all,
    and every gradient within ``RUN_TOL`` per unit of the plain version's
    on the CPU from the same weights and input."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tm = build_model(get_arch("falcon-mamba-7b").reduced())
    p = tm.init(torch.Generator().manual_seed(0), device="cpu")
    mamba = {k: v[0] for k, v in p["blocks"]["mamba"].items()}
    x = torch.randn((2, 40, tm.cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def grads(device):
        leaves = {k: v.to(device).requires_grad_() for k, v in mamba.items()}
        xd = x.to(device).requires_grad_()
        out = ssm.mamba_forward(leaves, xd, tm.cfg)
        g = torch.autograd.grad(out.square().sum(), [*leaves.values(), xd])
        return [t.cpu() for t in g]

    before = _counts()
    card = grads("cuda")
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 1, 1)
    for g, w in zip(card, grads("cpu")):
        err = float((g - w).abs().max())
        assert err <= RUN_TOL * max(float(w.abs().max()), 1.0)


@pytest.mark.cuda
def test_dense_training_on_the_card_tracks_the_cpu():
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tm = build_model(get_arch("qwen2-0.5b").reduced())
    p = _cooled(tm.init(torch.Generator().manual_seed(0), device="cpu"))
    streams = lm.federated_token_clients(3, tm.cfg.vocab_size, 4_000)
    k1, k3 = feature_attention_kernel.launches, flash_attention_kernel.launches
    card = tr.train(tm, tree_map(lambda t: t.to("cuda"), p), streams,
                    device="cuda", log=None, **LOOP)
    assert feature_attention_kernel.launches - k1 == LOOP["steps"]
    assert flash_attention_kernel.launches == k3
    cpu = tr.train(tm, p, streams, device="cpu", log=None, **LOOP)
    want = np.array(cpu["losses"])
    assert np.max(np.abs(np.array(card["losses"]) - want)) <= RUN_TOL * max(
        np.max(np.abs(want)), 1.0)
    got = dict(tree_flatten_with_path(card["params"]))
    for path, w in tree_flatten_with_path(cpu["params"]):
        err = float((got[path].cpu() - w).abs().max())
        assert err <= RUN_TOL * max(float(w.abs().max()), 1.0), path


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 32), (2, 13, 33), (1, 1, 300),
                                   (1, 100, 1024), (3, 9, 7)])
@pytest.mark.parametrize("with_last", [False, True])
def test_k2_backward_kernel_matches_plain_version(shape, with_last):
    """Bit for bit in fp32, S a multiple of the kernel's unroll (8) or
    not; then through LinearScan: one forward and one backward launch,
    the gradients bit for bit the plain loop's."""
    _card()
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.uniform(0.5, 0.999, shape), dtype=torch.float32,
                     device="cuda")
    b, dh = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _ in "bd")
    dh_last = torch.tensor(rng.standard_normal((shape[0], shape[2])),
                           dtype=torch.float32, device="cuda")
    h, _ = linear_scan_kernel(a, b)
    dl = dh_last if with_last else None
    before = linear_scan_backward_kernel.launches
    got = linear_scan_backward_kernel(a, h, dh, dl)
    torch.cuda.synchronize()
    assert linear_scan_backward_kernel.launches == before + 1
    want = linear_scan_backward_ref(a, h, dh, dl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    k2 = linear_scan_kernel.launches
    a_g, b_g = a.clone().requires_grad_(), b.clone().requires_grad_()
    h2, h2_last = linear_scan(a_g, b_g)
    loss = (h2 * dh).sum() + ((h2_last * dh_last).sum() if with_last else 0)
    fn = torch.autograd.grad(loss, [a_g, b_g])
    torch.cuda.synchronize()
    assert linear_scan_kernel.launches == k2 + 1
    assert linear_scan_backward_kernel.launches == before + 2
    assert torch.equal(h2, h)
    for f, w in zip(fn, want):
        assert torch.equal(f, w)
