"""The training slice on the CUDA card (every case carries the ``cuda``
marker and skips without a card; this file imports no JAX, so it runs
where the port runs).

* K3's and K2's wrappers refuse CUDA inputs that require grad, and SSM
  and hybrid training on the card (whose recurrences reach K2) raises
  by name;
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
    linear_scan_kernel)
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402

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
    with pytest.raises(RuntimeError, match="linear_scan_kernel has no "
                       "backward"):
        linear_scan_kernel(b.detach(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_ssm_and_hybrid_loss_on_the_card_raises(arch):
    _card()
    tm = build_model(get_arch(arch).reduced())
    p = tm.init(torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
    p = tree_map(lambda t: t.requires_grad_(), p)
    with pytest.raises(RuntimeError, match="linear_scan_kernel has no "
                       "backward"):
        tm.loss(p, make_batch(tm.cfg, 2, 24, seed=1, device="cuda"))


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
