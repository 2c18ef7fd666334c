"""The port's Local-S and Global baselines (the sweep schedule) against
the JAX package's engine, per-client evaluation, Global's pooled
batches, and the ``repro_torch.core.federated`` façade.

JAX's Local draws client k's start from ``PRNGKey(seed + k)``, which
torch cannot replay: the port's Local is started from those draws
through ``init_params`` (one mapping per client).  Trajectories and eval
metrics are held to the engine-vs-oracle tolerance of
``tests/test_sim_engine.py`` (atol 3e-4, rtol 3e-3); numpy batch
construction is held bit for bit."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import federated as jax_federated  # noqa: E402
from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro.sim.engine import stack_batches as jax_stack_batches  # noqa: E402
from repro.sim.evaluation import Evaluator as JaxEvaluator  # noqa: E402
from repro.sim.telemetry import TelemetryLog as JaxTelemetryLog  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro.sim.workloads import resolve_eval_report as jax_report  # noqa: E402
from repro_torch.core import federated  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sim.engine import run_strategy, stack_batches  # noqa: E402
from repro_torch.sim.evaluation import Evaluator  # noqa: E402
from repro_torch.sim.telemetry import TelemetryLog  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402
from repro_torch.sim.workloads import resolve_eval_report  # noqa: E402

ATOL, RTOL = 3e-4, 3e-3
K, T = 5, 8


def _cfg(wl, **kw):
    kw = {"T": T, "eval_every": 4, **kw}
    return wl.run_config(batch_size=8, local_epochs=2, eta=0.02, seed=0,
                         **kw)


def _jax_starts(name, alg):
    """The JAX package's starting weights: one w0 (global), or each
    client's PRNGKey(seed + cid) draw (local)."""
    _, model = jax_get_workload(name).build(hidden=12)
    draw = lambda s: jax.tree.map(  # noqa: E731
        np.asarray, model.init(jax.random.PRNGKey(s)))
    return [draw(cid) for cid in range(K)] if alg == "local" else draw(0)


@functools.lru_cache(maxsize=None)
def _jax(name, alg):
    wl = jax_get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    trace, telem, stats = [], JaxTelemetryLog(), {}
    hist = jax_run_strategy(jax_get_strategy(alg), model, cfg_model,
                            wl.make_clients(K, n_per=60, seed=0), _cfg(wl),
                            trace=trace, telemetry=telem, stats=stats)
    return hist, trace, telem, stats


def _port(name, alg, init_params=None, **cfg_kw):
    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    trace, telem, stats = [], TelemetryLog(), {}
    hist = run_strategy(get_strategy(alg), model, cfg_model,
                        wl.make_clients(K, n_per=60, seed=0),
                        _cfg(wl, **cfg_kw), device="cpu",
                        init_params=init_params, trace=trace,
                        telemetry=telem, stats=stats)
    return hist, trace, telem, stats


@pytest.mark.parametrize("alg", ["local", "global"])
@pytest.mark.parametrize("name", ["lstm_regression", "cnn_classification"])
def test_sweep_baselines_match_jax_engine(name, alg):
    jhist, jtrace, jtelem, jstats = _jax(name, alg)
    hist, trace, telem, stats = _port(name, alg, _jax_starts(name, alg))
    # every round is one tick; Local's trace holds the (K, ...) stack
    assert [t for t, _ in trace] == [t for t, _ in jtrace] == \
        list(range(1, T + 1))
    for (t, w), (_, jw) in zip(trace, jtrace):
        assert set(w) == set(jw)
        for k in w:
            assert w[k].shape == jw[k].shape
            np.testing.assert_allclose(w[k], jw[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{alg} {k} t={t}")
    assert [(h.global_iter, h.sim_time) for h in hist] == \
        [(h.global_iter, h.sim_time) for h in jhist]
    for h, jh in zip(hist, jhist):
        assert set(h.metrics) == set(jh.metrics)
        for m in jh.metrics:
            np.testing.assert_allclose(h.metrics[m], jh.metrics[m],
                                       atol=ATOL, rtol=RTOL, err_msg=m)
    assert telem.slots == jtelem.slots
    assert len(telem.records) == len(jtelem.records) == T
    for r, jr in zip(telem.records, jtelem.records):
        assert (r.t, r.sim_time, r.n_folds) == (jr.t, jr.sim_time,
                                                 jr.n_folds)
        for s in telem.slots:
            np.testing.assert_allclose(r.values[s], jr.values[s], atol=ATOL,
                                       rtol=RTOL, err_msg=s)
    # the members counted in each round's folds_per_tick slot
    assert [r.values["folds_per_tick"] for r in telem.records] == \
        [float(K if alg == "local" else 1)] * T
    for key in ("iters", "ticks", "windows", "sim_time", "upload_bytes",
                "upload_bytes_total", "window"):
        assert stats[key] == jstats[key], key
    assert stats["upload_bytes"] == 0.0 and stats["sim_time"] == float(T)


@pytest.mark.parametrize("t", [1, 3])
def test_pooled_batches_bitwise(t):
    jwl, wl = jax_get_workload("lstm_regression"), get_workload(
        "lstm_regression")
    jcl = jwl.make_clients(K, n_per=60, seed=0)
    cl = wl.make_clients(K, n_per=60, seed=0)
    for _ in range(2):  # consecutive draws advance both streams alike
        jxs, jys = jax_get_strategy("global").pooled_batches(
            jcl, t, _cfg(jwl))
        xs, ys = get_strategy("global").pooled_batches(cl, t, _cfg(wl))
        assert xs.shape == (4, 8) + jcl[0].stream.x.shape[1:]
        np.testing.assert_array_equal(xs, jxs)
        np.testing.assert_array_equal(ys, jys)
    # the oracle's allocating path, including a client's short window
    for c, jc in zip(cl, jcl):
        for a, b in zip(stack_batches(c.stream, 0, 64, 2),
                        jax_stack_batches(jc.stream, 0, 64, 2)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["lstm_regression", "cnn_classification",
                                  "lstm_multilabel"])
def test_local_per_client_eval_matches_jax(name):
    """One stacked predict over the (K, n_max, ...) test block: client k's
    model on client k's split, as JAX's vmapped predict; and equal to K
    separate predicts, one per client, on the port's side."""
    jwl, wl = jax_get_workload(name), get_workload(name)
    _, jmodel = jwl.build(hidden=12)
    _, model = wl.build(hidden=12)
    starts = _jax_starts(name, "local")
    stacked = {k: np.stack([s[k] for s in starts]) for k in starts[0]}
    jcl = jwl.make_clients(K, n_per=60, seed=0)
    cl = wl.make_clients(K, n_per=60, seed=0)
    cfg = _cfg(wl)
    jev = JaxEvaluator(jmodel, jcl, jax_report(_cfg(jwl)), True)
    ev = Evaluator(model, cl, resolve_eval_report(cfg), torch.device("cpu"),
                   per_client=True)
    preds = ev.predict_device(params_from_numpy(stacked, device="cpu"))
    jpreds = np.asarray(jev.predict_device(jax.tree.map(jnp.asarray,
                                                        stacked)))
    np.testing.assert_allclose(preds.numpy(), jpreds, atol=ATOL, rtol=RTOL)
    got, want = ev.metrics_from(preds), jev.metrics_from(jpreds)
    assert set(got) == set(want)
    for m in want:
        np.testing.assert_allclose(got[m], want[m], atol=ATOL, rtol=RTOL,
                                   err_msg=m)
    with torch.no_grad():
        for k, c in enumerate(cl):
            one = model.predict(params_from_numpy(starts[k], device="cpu"),
                                {"x": torch.tensor(c.test_x)})
            np.testing.assert_allclose(preds[k, :len(c.test_x)].numpy(),
                                       one.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("alg", ["local", "global"])
def test_foldless_strategies_accept_any_mode(alg):
    """local/global have no server fold: the associative mode degrades to
    a no-op rather than raising, as in the JAX package."""
    hist, trace, _, stats = _port("lstm_regression", alg,
                                  _jax_starts("lstm_regression", alg), T=4,
                                  eval_every=2, fold_mode="associative")
    assert hist and stats["fold_mode"] == "sequential"
    _, seq, _, _ = _port("lstm_regression", alg,
                         _jax_starts("lstm_regression", alg), T=4,
                         eval_every=2)
    for (_, w), (_, v) in zip(trace, seq):
        for k in w:
            np.testing.assert_array_equal(w[k], v[k])


def test_local_seeded_starts_are_per_client_and_reproducible():
    _, tr_a, _, _ = _port("lstm_regression", "local", T=2)
    _, tr_b, _, _ = _port("lstm_regression", "local", T=2)
    w = tr_a[-1][1]["w_x"]
    assert w.shape[0] == K and not np.array_equal(w[0], w[1])
    for (_, a), (_, b) in zip(tr_a, tr_b):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("alg,init,match", [
    ("local", "one", "per-client mappings"),
    ("local", "short", "3 per-client mappings for 5 clients"),
    ("global", "per_client", "takes one mapping"),
    ("asofed", "per_client", "takes one mapping"),
])
def test_init_params_shape_must_fit_the_strategy(alg, init, match):
    starts = _jax_starts("lstm_regression", "local")
    init_params = {"one": starts[0], "short": starts[:3],
                   "per_client": starts}[init]
    with pytest.raises(ValueError, match=match):
        _port("lstm_regression", alg, init_params, T=2)


def test_facade_algorithms_match_jax():
    assert sorted(federated.ALGORITHMS) == sorted(jax_federated.ALGORITHMS)
    assert sorted(federated.__all__) == sorted(jax_federated.__all__)
    from repro_torch import core

    for name in ("ServerState", "aggregate", "init_server", "run",
                 "ALGORITHMS", "receive_server_model", "client_step"):
        assert name in core.__all__ and hasattr(core, name)
    with pytest.raises(KeyError, match="unknown strategy"):
        get_strategy("scaffold")


@pytest.mark.parametrize("name", sorted(federated.ALGORITHMS))
def test_facade_runs_every_strategy_on_the_cpu(name):
    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=6)
    cfg = wl.run_config(T=6, batch_size=8, local_epochs=1, eval_every=3,
                        seed=0, participation=0.6)
    stats = {}
    hist = federated.ALGORITHMS[name](model, cfg_model,
                                      wl.make_clients(4, n_per=40, seed=0),
                                      cfg, device="cpu", stats=stats)
    # async runs evaluate at the first tick boundary past each multiple
    assert len(hist) == 2 and hist[-1].global_iter == 6 == stats["iters"]
    assert all(np.isfinite(v) for h in hist for v in h.metrics.values())
    assert stats["device"] == "cpu"
