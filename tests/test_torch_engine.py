"""The port's cohort engine (asofed, sequential fold) against the JAX
package's engine and its per-arrival oracle, on all three workloads, and
the port's own bitwise contracts (window size, prefetch)."""
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

from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro.sim.reference import run_asofed_reference  # noqa: E402
from repro.sim.telemetry import TelemetryLog as JaxTelemetryLog  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.telemetry import TelemetryLog  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

# the engine-vs-oracle tolerance of tests/test_sim_engine.py
ATOL, RTOL = 3e-4, 3e-3
WORKLOADS = [("lstm_regression", 60), ("cnn_classification", 30),
             ("lstm_multilabel", 60)]


def _cfg(wl, T, **kw):
    kw = {"eval_every": 30, **kw}
    return wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                         lam=1.0, beta=0.001, seed=0, **kw)


def _port_run(name, T, *, w0=None, cfg_kw=None, alg="asofed", **kw):
    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    trace, telem, stats = [], TelemetryLog(), {}
    hist = run_strategy(get_strategy(alg), model, cfg_model,
                        wl.make_clients(5, n_per=60, seed=0),
                        _cfg(wl, T, **(cfg_kw or {})), device="cpu",
                        init_params=w0, trace=trace, telemetry=telem,
                        stats=stats, **kw)
    return hist, trace, telem, stats


def _assert_traj_close(trace, reference):
    assert trace, "the port produced no ticks"
    for t, w in trace:
        assert t in reference, f"port tick boundary t={t} not in reference"
        assert set(w) == set(reference[t])
        for k in w:
            np.testing.assert_allclose(w[k], reference[t][k], atol=ATOL,
                                       rtol=RTOL,
                                       err_msg=f"{k} diverges at t={t}")


@pytest.mark.parametrize("name,T", WORKLOADS)
def test_port_matches_jax_engine_and_oracle(name, T):
    jwl = jax_get_workload(name)
    cfg_model, jmodel = jwl.build(hidden=12)
    cfg = _cfg(jwl, T)
    w0 = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(cfg.seed)))
    ref = run_asofed_reference(jmodel, cfg_model,
                               jwl.make_clients(5, n_per=60, seed=0), cfg)
    jtrace, jtelem = [], JaxTelemetryLog()
    jhist = jax_run_strategy(jax_get_strategy("asofed"), jmodel, cfg_model,
                             jwl.make_clients(5, n_per=60, seed=0), cfg,
                             trace=jtrace, telemetry=jtelem)
    hist, trace, telem, stats = _port_run(name, T, w0=w0)

    assert stats["iters"] == T
    assert len(trace) >= 2
    # server weights at every tick boundary: the per-arrival oracle and
    # the JAX engine (same boundaries: both engines tick identically)
    _assert_traj_close(trace, ref)
    assert [t for t, _ in trace] == [t for t, _ in jtrace]
    _assert_traj_close(trace, dict(jtrace))
    # eval history: same points, metrics within the same tolerance
    assert [(h.global_iter, h.sim_time) for h in hist] == \
        [(h.global_iter, h.sim_time) for h in jhist]
    for h, jh in zip(hist, jhist):
        assert set(h.metrics) == set(jh.metrics)
        for m in h.metrics:
            np.testing.assert_allclose(h.metrics[m], jh.metrics[m],
                                       atol=ATOL, rtol=RTOL, err_msg=m)
    # per-tick telemetry rows: host metadata exact, in-tick values close
    assert telem.slots == jtelem.slots
    assert len(telem.records) == len(jtelem.records)
    for r, jr in zip(telem.records, jtelem.records):
        assert (r.t, r.sim_time, r.n_folds, r.staleness_mean,
                r.staleness_max) == (jr.t, jr.sim_time, jr.n_folds,
                                     jr.staleness_mean, jr.staleness_max)
        for s in telem.slots:
            np.testing.assert_allclose(r.values[s], jr.values[s],
                                       atol=ATOL, rtol=RTOL, err_msg=s)


def _assert_bitwise(trace_a, trace_b):
    b = dict(trace_b)
    common = [t for t, _ in trace_a if t in b]
    assert common and common[-1] == trace_a[-1][0] == trace_b[-1][0]
    for t, w in trace_a:
        if t in b:
            for k in w:
                np.testing.assert_array_equal(w[k], b[t][k])


@pytest.mark.parametrize("name,T", [WORKLOADS[0], WORKLOADS[1]])
def test_window_one_vs_four_bitwise(name, T):
    h1, tr1, tel1, st1 = _port_run(name, T, window=1, prefetch=False)
    h4, tr4, tel4, st4 = _port_run(name, T, window=4, prefetch=False)
    assert st4["windows"] < st1["windows"] and st4["ticks"] == st1["ticks"]
    _assert_bitwise(tr4, tr1)
    assert [dataclasses.astuple(r) for r in tel4.records] == \
        [dataclasses.astuple(r) for r in tel1.records]


@pytest.mark.parametrize("window", [1, 4])
def test_prefetch_on_vs_off_bitwise(window):
    name, T = WORKLOADS[2]
    h_on, tr_on, tel_on, st_on = _port_run(name, T, window=window,
                                           prefetch=True)
    h_off, tr_off, tel_off, st_off = _port_run(name, T, window=window,
                                               prefetch=False)
    assert st_on["prefetch"] and not st_off["prefetch"]
    assert [t for t, _ in tr_on] == [t for t, _ in tr_off]
    _assert_bitwise(tr_on, tr_off)
    assert [h.metrics for h in h_on] == [h.metrics for h in h_off]
    assert [dataclasses.astuple(r) for r in tel_on.records] == \
        [dataclasses.astuple(r) for r in tel_off.records]


@pytest.mark.parametrize("cfg_kw,run_kw", [
    (dict(dropout_frac=0.4, periodic_dropout=0.2), {}),
    ({}, dict(max_cohort=2, window=4)),
    (dict(eval_align=True, eval_every=7), dict(window=4)),
])
def test_port_matches_oracle_under_scheduler_knobs(cfg_kw, run_kw):
    """Dropout, skips, cohort caps and eval-aligned windows live in the
    copied host layer: the port must still track the per-arrival oracle."""
    jwl = jax_get_workload("lstm_regression")
    cfg_model, jmodel = jwl.build(hidden=12)
    cfg = _cfg(jwl, 40, **cfg_kw)
    w0 = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(cfg.seed)))
    ref = run_asofed_reference(jmodel, cfg_model,
                               jwl.make_clients(5, n_per=60, seed=0), cfg)
    hist, trace, _, stats = _port_run("lstm_regression", 40, w0=w0,
                                      cfg_kw=cfg_kw, **run_kw)
    assert stats["iters"] == max(ref)
    _assert_traj_close(trace, ref)
    if cfg_kw.get("eval_align"):
        # windows split at the eval cadence: evals land where window=1's do
        hist1, _, _, _ = _port_run("lstm_regression", 40, w0=w0,
                                   cfg_kw=cfg_kw, window=1)
        assert [h.global_iter for h in hist] == \
            [h.global_iter for h in hist1]
        assert len(hist) > 40 // 7


def test_port_drops_empty_split_clients():
    """A client with no local data never folds fabricated zero batches:
    its arrivals are dropped, as the JAX engine and oracle drop them."""
    jwl = jax_get_workload("lstm_regression")
    cfg_model, jmodel = jwl.build(hidden=12)
    cfg = _cfg(jwl, 24)
    w0 = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(cfg.seed)))
    data = list(jwl.make_data(4, n_per=60))
    x0, y0, xt, yt = data[0]
    data[0] = (x0[:0], y0[:0], xt, yt)
    from repro.sim.profiles import make_sim_clients as jax_make_clients
    from repro_torch.sim.profiles import make_sim_clients

    ref = run_asofed_reference(jmodel, cfg_model, jax_make_clients(data),
                               cfg)
    wl = get_workload("lstm_regression")
    pcfg_model, pmodel = wl.build(hidden=12)
    trace = []
    hist = run_strategy(get_strategy("asofed"), pmodel, pcfg_model,
                        make_sim_clients(data), _cfg(wl, 24), device="cpu",
                        init_params=w0, trace=trace)
    _assert_traj_close(trace, ref)
    assert hist[-1].global_iter == 24
    assert np.isfinite(hist[-1].metrics["mae"])


def test_seeded_init_is_reproducible():
    _, tr_a, _, _ = _port_run("lstm_regression", 20)
    _, tr_b, _, _ = _port_run("lstm_regression", 20)
    _assert_bitwise(tr_a, tr_b)


@pytest.mark.parametrize("cfg_kw,run_kw,knob", [
    (dict(fold_mode="associative"), {}, "fold_mode"),
    # host residency, the bf16 / fp16 / int8 / int4 codecs, the upload
    # codecs and the admission guards are ported
    # (tests/test_torch_state_pool.py, tests/test_torch_upload_codecs.py,
    # tests/test_torch_faults.py): their knobs still refuse a value they
    # do not know, with the JAX engine's message
    pytest.param(dict(upload_codec="quantized_delta", upload_bits=1), {},
                 r"upload_bits must be in \[2, 16\], got 1",
                 id="cfg_kw1-run_kw1-upload_codec"),
    (dict(state_residency="disk"), {}, "state_residency"),
    pytest.param(dict(state_dtype="int3"), {}, "unknown state dtype 'int3'",
                 id="cfg_kw3-run_kw3-state_dtype"),
    pytest.param(dict(upload_codec="topk"), {},
                 "unknown upload_codec 'topk'",
                 id="cfg_kw4-run_kw4-upload_codec"),
    pytest.param(dict(max_staleness=4.0, staleness_policy="drop"), {},
                 "unknown staleness_policy 'drop'",
                 id="cfg_kw5-run_kw5-max_staleness"),
    pytest.param(dict(max_delta_norm=1.0, upload_codec="random_mask",
                      upload_frac=0.0), {},
                 r"upload_frac must be in \(0, 1\], got 0.0",
                 id="cfg_kw6-run_kw6-max_delta_norm"),
    # run checkpoints and resume are ported
    # (tests/test_torch_checkpoint.py): the sync and sweep schedules
    # still refuse them, with the JAX engine's message
    pytest.param({}, dict(alg="fedavg", checkpoint_path="ckpt"),
                 "run checkpointing / resume is supported for async "
                 r"schedules only \('fedavg' is 'sync'\)",
                 id="cfg_kw7-run_kw7-checkpoint_path"),
    pytest.param({}, dict(alg="local", resume_from="ckpt"),
                 "run checkpointing / resume is supported for async "
                 r"schedules only \('local' is 'sweep'\)",
                 id="cfg_kw8-run_kw8-resume_from"),
    ({}, dict(mesh="auto"), "mesh"),
])
def test_knobs_outside_the_slice_raise(cfg_kw, run_kw, knob):
    with pytest.raises(ValueError, match=knob):
        _port_run("lstm_regression", 4, cfg_kw=cfg_kw, **run_kw)


def test_faults_and_other_schedules_raise():
    from repro_torch.sim.faults import FaultSpec

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=4)
    clients = wl.make_clients(3, n_per=20, seed=0)
    clients[1].profile = dataclasses.replace(
        clients[1].profile, faults=FaultSpec.uniform(0.2))
    # faults are ported (tests/test_torch_faults.py); a strategy that
    # cannot rebuild a crashed client's row still fails fast, with the
    # JAX engine's message
    no_init = get_strategy("asofed")
    no_init.build_init_client = lambda model, cfg: None
    with pytest.raises(ValueError, match="fault injection needs 'asofed' "
                       "to provide build_init_client"):
        run_strategy(no_init, model, cfg_model, clients, _cfg(wl, 4),
                     device="cpu")
    other = get_strategy("asofed")
    other.schedule = "gossip"
    with pytest.raises(ValueError, match="strategy.schedule='gossip'"):
        run_strategy(other, model, cfg_model,
                     wl.make_clients(3, n_per=20, seed=0), _cfg(wl, 4),
                     device="cpu")
    # every strategy of the JAX package is ported; an unknown name still
    # raises KeyError
    with pytest.raises(KeyError, match="unknown strategy 'scaffold'"):
        get_strategy("scaffold")
