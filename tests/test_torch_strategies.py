"""The port's FedAsync, FedBuff, ASO-Fed(-F), FedAvg and FedProx against
the JAX package's engine and per-arrival oracles, under the sequential
and the associative server fold.

Every run starts both packages from the JAX package's ``w0`` and replays
the same arrival stream (the host layer is shared).  Port and reference
never match bit for bit across frameworks (``(1+staleness)**-rho`` and
``cumprod`` differ by ulps between torch and XLA), so trajectories are
held to the engine-vs-oracle tolerance of ``tests/test_sim_engine.py``.
Single-fold ticks are not pinned bitwise between the two fold modes: the
JAX package's own test of that fails.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim import reference as jax_reference  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro.sim.telemetry import TelemetryLog as JaxTelemetryLog  # noqa: E402
from repro.sim.traces import scenario_traces as jax_scenario_traces  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.telemetry import TelemetryLog  # noqa: E402
from repro_torch.sim.traces import scenario_traces  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

# the engine-vs-oracle tolerance of tests/test_sim_engine.py
ATOL, RTOL = 3e-4, 3e-3
NAME = "lstm_regression"
# strategy -> (config overrides, oracle call)
ALGS = {
    "fedasync": ({}, lambda m, cm, cl, cfg: jax_reference.
                 run_fedasync_reference(m, cm, cl, cfg)),
    "fedbuff": ({"buffer_size": 3}, lambda m, cm, cl, cfg: jax_reference.
                run_fedbuff_reference(m, cm, cl, cfg)),
    "asofed": ({"feature_learning": False}, lambda m, cm, cl, cfg:
               jax_reference.run_asofed_reference(m, cm, cl, cfg)),
    "fedavg": ({"participation": 0.6}, lambda m, cm, cl, cfg: jax_reference.
               run_fedavg_reference(m, cm, cl, cfg, prox_mu=0.0)),
    "fedprox": ({"participation": 0.6, "prox_mu": 0.02},
                lambda m, cm, cl, cfg: jax_reference.run_fedavg_reference(
                    m, cm, cl, cfg, prox_mu=0.02)),
}
SYNC = ("fedavg", "fedprox")


def _cfg(wl, alg, **kw):
    # sync strategies count rounds, async ones folded arrivals
    T, every = (8, 4) if alg in SYNC else (36, 18)
    kw = {**ALGS[alg][0], **kw}
    return wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                         lam=1.0, beta=0.001, eval_every=every, seed=0,
                         **kw)


def _traces(traced, fn):
    return (fn("diurnal", 5, seed=0, period=150.0, duty=0.55)
            if traced else None)


@functools.lru_cache(maxsize=None)
def _jax(alg, fold_mode="sequential", window=1, traced=False):
    """(w0, trace, history, telemetry) of the JAX engine."""
    wl = jax_get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    cfg = _cfg(wl, alg, fold_mode=fold_mode)
    w0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(cfg.seed)))
    trace, telem = [], JaxTelemetryLog()
    hist = jax_run_strategy(
        jax_get_strategy(alg), model, cfg_model,
        wl.make_clients(5, n_per=60, seed=0,
                        traces=_traces(traced, jax_scenario_traces)),
        cfg, trace=trace, telemetry=telem, window=window)
    return w0, trace, hist, telem


@functools.lru_cache(maxsize=None)
def _oracle(alg):
    wl = jax_get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    return ALGS[alg][1](model, cfg_model,
                        wl.make_clients(5, n_per=60, seed=0), _cfg(wl, alg))


def _port(alg, fold_mode="sequential", window=1, traced=False, **cfg_kw):
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    trace, telem, stats = [], TelemetryLog(), {}
    hist = run_strategy(
        get_strategy(alg), model, cfg_model,
        wl.make_clients(5, n_per=60, seed=0,
                        traces=_traces(traced, scenario_traces)),
        _cfg(wl, alg, fold_mode=fold_mode, **cfg_kw), device="cpu",
        init_params=_jax(alg)[0], trace=trace, telemetry=telem,
        stats=stats, window=window)
    return hist, trace, telem, stats


def _close(trace, reference, tag=""):
    """``trace`` within tolerance of ``reference`` ({t: weights}) at every
    boundary both have; at least two, the last one included."""
    ref = dict(reference)
    common = [t for t, _ in trace if t in ref]
    assert len(common) >= 2 and common[-1] == trace[-1][0], tag
    for t, w in trace:
        if t in ref:
            assert set(w) == set(ref[t]), tag
            for k in w:
                np.testing.assert_allclose(w[k], ref[t][k], atol=ATOL,
                                           rtol=RTOL,
                                           err_msg=f"{tag} {k} at t={t}")


@pytest.mark.parametrize("alg", sorted(ALGS))
def test_sequential_matches_jax_engine_and_oracle(alg):
    _, jtrace, jhist, jtelem = _jax(alg)
    hist, trace, telem, stats = _port(alg)
    assert stats["fold_mode"] == "sequential"
    assert [t for t, _ in trace] == [t for t, _ in jtrace]
    _close(trace, jtrace, "jax engine")
    _close(trace, _oracle(alg), "oracle")
    assert [(h.global_iter, h.sim_time) for h in hist] == \
        [(h.global_iter, h.sim_time) for h in jhist]
    for h, jh in zip(hist, jhist):
        for m in jh.metrics:
            np.testing.assert_allclose(h.metrics[m], jh.metrics[m],
                                       atol=ATOL, rtol=RTOL, err_msg=m)
    # same slots (fedbuff's server slot after folds_per_tick), same rows
    assert telem.slots == jtelem.slots
    assert len(telem.records) == len(jtelem.records)
    for r, jr in zip(telem.records, jtelem.records):
        assert (r.t, r.sim_time, r.n_folds) == (jr.t, jr.sim_time,
                                                 jr.n_folds)
        for s in telem.slots:
            np.testing.assert_allclose(r.values[s], jr.values[s], atol=ATOL,
                                       rtol=RTOL, err_msg=s)


@pytest.mark.parametrize("alg,window,traced", [
    ("fedasync", 1, False), ("fedasync", 6, False), ("fedasync", 6, True),
    ("fedbuff", 1, False), ("fedbuff", 6, False),
    ("asofed", 1, False), ("asofed", 6, False),
    ("fedavg", 1, False), ("fedprox", 1, False),
])
def test_associative_matches_sequential_and_jax(alg, window, traced):
    _, seq, _, _ = _port(alg, traced=traced)
    _, par, _, stats = _port(alg, "associative", window, traced)
    assert stats["fold_mode"] == "associative"
    _close(par, seq, "port sequential")
    # the JAX engine's trajectory does not depend on its window
    _close(par, _jax(alg, "associative", 6, traced)[1], "jax associative")


def test_fedbuff_buffer_fill_counts_folds_mod_m():
    _, _, telem, _ = _port("fedbuff", "associative", 6)
    _, fill = telem.curve("buffer_fill")
    cum = np.cumsum([r.n_folds for r in telem.records])
    np.testing.assert_array_equal(fill, (cum % 3).astype(np.float32))


def test_auto_is_bitwise_sequential_on_cpu():
    _, seq, _, _ = _port("fedasync", window=4)
    _, aut, _, stats = _port("fedasync", "auto", 4)
    assert stats["fold_mode"] == "sequential"
    assert [t for t, _ in aut] == [t for t, _ in seq]
    for (_, w), (_, v) in zip(aut, seq):
        for k in w:
            np.testing.assert_array_equal(w[k], v[k])


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("mode,match", [
    ("associative", "declines the affine fold"),
    ("parallel", "unknown fold_mode"),
])
def test_fold_mode_refusals_match_jax(mode, match):
    """Forcing the associative fold on ASO-Fed with its (non-affine)
    feature pass, or naming an unknown mode, raises before any work with
    the JAX package's message."""
    jwl, wl = jax_get_workload(NAME), get_workload(NAME)
    jcm, jmodel = jwl.build(hidden=4)
    cm, model = wl.build(hidden=4)
    kw = dict(T=4, fold_mode=mode)
    want = _raised(lambda: jax_run_strategy(
        jax_get_strategy("asofed"), jmodel, jcm,
        jwl.make_clients(3, n_per=20, seed=0), jwl.run_config(**kw)))
    got = _raised(lambda: run_strategy(
        get_strategy("asofed"), model, cm,
        wl.make_clients(3, n_per=20, seed=0), wl.run_config(**kw),
        device="cpu"))
    assert match in got and got == want


def test_fold_kernel_must_agree_with_the_device():
    with pytest.raises(ValueError, match="fold_kernel=True"):
        _port("fedasync", "associative", 1, fold_kernel=True)
