"""The port's paper models, losses and per-client gradients against the
JAX package, from the same (converted) weights and numpy inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
# full fp32 wherever these run (PyTorch convolves fp32 in TF32 on a
# card by default)
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import client as jax_client  # noqa: E402
from repro.models import LOCAL, build_model as jax_build_model  # noqa: E402
from repro.models import paper_nets as jpn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import client as client_lib  # noqa: E402
from repro_torch.core.algorithms.common import avg_surrogate_grad  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import paper_nets as pn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sim.engine import RunConfig  # noqa: E402

ATOL = 1e-5
F, H, C = 8, 12, 4
RNG = np.random.default_rng(11)


def _models(arch, **kw):
    jcfg = dataclasses.replace(jax_get_arch(arch), **kw)
    tcfg = dataclasses.replace(get_arch(arch), **kw)
    return jcfg, jax_build_model(jcfg, LOCAL), tcfg, build_model(tcfg)


def _w(jmodel, seed):
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def test_convert_keeps_layouts_and_copies():
    _, jm, _, _ = _models("paper-lstm", in_features=F, out_features=1,
                          hidden=H)
    w = _w(jm, 0)
    t = params_from_numpy(w)
    assert t["w_x"].shape == (F, 4 * H) and t["w_h"].shape == (H, 4 * H)
    t["w_x"].add_(1.0)  # a copy, not an alias of the numpy array
    assert not np.allclose(t["w_x"].numpy(), w["w_x"])


def test_init_matches_spec_shapes_and_fan_in():
    _, jm, _, tm = _models("paper-cnn", out_features=10, hidden=C)
    w = tm.init(torch.Generator().manual_seed(0))
    jw = _w(jm, 0)
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: v.shape for k, v in jw.items()}
    assert float(w["conv1_b"].abs().sum()) == 0.0
    # fan_in rule: std 1/sqrt(shape[-2]) = 1/sqrt(14*14*C) for fc_w
    std = float(w["fc_w"].std())
    assert abs(std * np.sqrt(14 * 14 * C) - 1.0) < 0.1


def test_lstm_forward_matches_jax():
    _, jm, _, _ = _models("paper-lstm", in_features=F, out_features=3,
                          hidden=H)
    w = _w(jm, 1)
    x = RNG.standard_normal((5, 16, F)).astype(np.float32)
    want = jpn.lstm_forward(w, jnp.asarray(x))
    got = pn.lstm_forward(params_from_numpy(w), torch.tensor(x))
    _close(got.numpy(), want)


def test_cnn_forward_matches_jax():
    _, jm, _, _ = _models("paper-cnn", out_features=10, hidden=C)
    w = _w(jm, 2)
    x = RNG.standard_normal((3, 28, 28, 1)).astype(np.float32)
    want = jpn.cnn_forward(w, jnp.asarray(x))
    got = pn.cnn_forward(params_from_numpy(w), torch.tensor(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("family", ["lstm", "cnn"])
def test_stacked_forward_equals_per_client(family):
    """The cohort form (leading client axis) computes each client's own
    forward pass."""
    if family == "lstm":
        _, jm, _, _ = _models("paper-lstm", in_features=F, out_features=2,
                              hidden=H)
        xs = RNG.standard_normal((3, 4, 10, F)).astype(np.float32)
        fwd = pn.lstm_forward
    else:
        _, jm, _, _ = _models("paper-cnn", out_features=10, hidden=C)
        xs = RNG.standard_normal((3, 2, 28, 28, 1)).astype(np.float32)
        fwd = pn.cnn_forward
    ws = [params_from_numpy(_w(jm, s)) for s in range(3)]
    stacked = {k: torch.stack([w[k] for w in ws]) for k in ws[0]}
    got = fwd(stacked, torch.tensor(xs))
    for p in range(3):
        _close(got[p].numpy(), fwd(ws[p], torch.tensor(xs[p])).numpy())


def test_losses_match_jax():
    pred = RNG.standard_normal((6, 1)).astype(np.float32)
    target = RNG.standard_normal((6,)).astype(np.float32)
    # the JAX loss broadcasts (B, 1) against (B,): the port keeps that
    _close(pn.regression_loss(torch.tensor(pred), torch.tensor(target)),
           jpn.regression_loss(pred, target))
    logits = RNG.standard_normal((6, 5)).astype(np.float32)
    labels = RNG.integers(0, 5, 6).astype(np.int32)
    _close(pn.classification_loss(torch.tensor(logits),
                                  torch.tensor(labels)),
           jpn.classification_loss(logits, labels))
    multi = (RNG.uniform(size=(6, 5)) < 0.4).astype(np.float32)
    _close(pn.multilabel_loss(torch.tensor(logits), torch.tensor(multi)),
           jpn.multilabel_loss(logits, multi))
    np.testing.assert_array_equal(
        pn.multilabel_predict(torch.tensor(logits), 0.3).numpy(),
        np.asarray(jpn.multilabel_predict(logits, 0.3)))


@pytest.mark.parametrize("task", ["regression", "classification",
                                  "multilabel"])
def test_stacked_losses_are_per_client(task):
    P, B = 3, 4
    logits = RNG.standard_normal((P, B, 5)).astype(np.float32)
    if task == "regression":
        logits = logits[..., :1]
        y = RNG.standard_normal((P, B)).astype(np.float32)
        fn = pn.regression_loss
    elif task == "classification":
        y = RNG.integers(0, 5, (P, B)).astype(np.int64)
        fn = pn.classification_loss
    else:
        y = (RNG.uniform(size=(P, B, 5)) < 0.4).astype(np.float32)
        fn = pn.multilabel_loss
    got = fn(torch.tensor(logits), torch.tensor(y))
    assert got.shape == (P,)
    for p in range(P):
        _close(got[p], fn(torch.tensor(logits[p]), torch.tensor(y[p])))


@pytest.mark.parametrize("workload", ["lstm_regression",
                                      "cnn_classification",
                                      "lstm_multilabel"])
def test_per_client_surrogate_grads_match_jax(workload):
    """``avg_surrogate_grad`` over a cohort: one backward of the summed
    losses gives each client its own gradient, equal to the JAX
    package's per-client ``jax.grad`` of the surrogate (Eq. 7)."""
    from repro.core.algorithms.common import (
        avg_surrogate_grad as jax_avg_surrogate_grad)
    from repro.sim.workloads import get_workload as jax_get_workload

    wl = jax_get_workload(workload)
    jcfg_model, jm = wl.build(hidden=H if wl.arch == "paper-lstm" else C)
    tm = build_model(dataclasses.replace(get_arch(wl.arch), **{
        f: getattr(jcfg_model, f)
        for f in ("in_features", "out_features", "hidden")}))
    cfg = RunConfig(task=wl.task, lam=0.7)
    data = wl.make_data(3, n_per=24, seed=5)
    P, E, B = 3, 2, 4
    xs = np.stack([np.stack([d[0][e * B:(e + 1) * B] for e in range(E)])
                   for d in data])
    ys = np.stack([np.stack([d[1][e * B:(e + 1) * B] for e in range(E)])
                   for d in data])
    ws = [_w(jm, s) for s in range(P)]
    ss = [_w(jm, 10 + s) for s in range(P)]
    jfn = jax.jit(jax_avg_surrogate_grad(jm, cfg))
    want = [jfn(ws[p], ss[p], jnp.asarray(xs[p]), jnp.asarray(ys[p]))
            for p in range(P)]
    stack = lambda trees: {k: torch.stack(  # noqa: E731
        [params_from_numpy(t)[k] for t in trees]) for k in trees[0]}
    g, loss = avg_surrogate_grad(tm, cfg)(
        stack(ws), stack(ss), torch.tensor(xs), torch.tensor(ys))
    for p in range(P):
        _close(loss[p], want[p][1])
        for k in g:
            # gradients reach |g| ~ 2 and sum a batch of conv / LSTM terms
            # in another order per framework: 1e-5 of fp32 relative slack
            _close(g[k][p].numpy(), want[p][0][k], rtol=1e-5)


def test_dynamic_multiplier_matches_jax():
    d = RNG.uniform(0, 300, 8).astype(np.float32)
    r = RNG.integers(0, 5, 8).astype(np.float32)
    nd = RNG.uniform(0, 100, 8).astype(np.float32)
    _close(client_lib.dynamic_multiplier(torch.tensor(d), torch.tensor(r),
                                         torch.tensor(nd)).numpy(),
           jax_client.dynamic_multiplier(d, r, nd))


def test_stacked_init_client_state():
    _, jm, _, _ = _models("paper-lstm", in_features=F, out_features=1,
                          hidden=H)
    w0 = params_from_numpy(_w(jm, 0))
    st = client_lib.init_client_state(w0, torch.tensor([3.0, 5.0]))
    assert st.params["w_x"].shape == (2, F, 4 * H)
    assert torch.equal(st.server_params["w_h"][1], w0["w_h"])
    assert float(st.v["w_x"].abs().sum()) == 0.0
    assert st.n_samples.tolist() == [3.0, 5.0]
    # rows are independent storage (the engine scatters into them)
    st.params["w_x"][0].add_(1.0)
    assert torch.equal(st.params["w_x"][1], w0["w_x"])
