"""The port's own per-arrival oracles (``repro_torch.sim.reference``) and
ASO-Fed server (``repro_torch.core.server``) against the JAX package's,
and the port's engine against the port's oracle.

Every oracle run starts both packages from the JAX package's ``w0`` and
replays the same arrival stream (the host layer is shared).  Trajectories
are held to the engine-vs-oracle tolerance of ``tests/test_sim_engine.py``
(atol 3e-4, rtol 3e-3); one ``aggregate`` step to 1e-6 per unit of the
largest |w| (fp32 ulps of the feature pass, scaled as the kernel checks
scale it)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import client as jax_client  # noqa: E402
from repro.core import server as jax_server  # noqa: E402
from repro.sim import reference as jax_reference  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.core import client as client_lib  # noqa: E402
from repro_torch.core import server as server_lib  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sim import reference  # noqa: E402
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

ATOL, RTOL = 3e-4, 3e-3
AGG_TOL = 1e-6  # per unit of max |w|
# oracle -> (config overrides, T, eval_every, extra oracle kwargs)
ORACLES = {
    "asofed": ({}, 30, 15, {}),
    "fedasync": ({}, 30, 15, {}),
    "fedbuff": ({"buffer_size": 3}, 30, 15, {}),
    "fedavg": ({"participation": 0.6}, 6, 3, {"prox_mu": 0.0}),
    "fedprox": ({"participation": 0.6}, 6, 3, {"prox_mu": 0.02}),
}


def _oracle_fn(module, alg):
    name = {"fedprox": "fedavg"}.get(alg, alg)
    return getattr(module, f"run_{name}_reference")


def _cfg(wl, alg, **kw):
    over, T, every, _ = ORACLES[alg]
    return wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                         lam=1.0, beta=0.001, eval_every=every, seed=0,
                         **{**over, **kw})


def _stat_kw(alg):
    # fedavg's oracle has no telemetry-losses hook, as in the JAX package
    return {} if alg in ("fedavg", "fedprox") else {"losses": {}}


@functools.lru_cache(maxsize=None)
def _jax_oracle(name, alg):
    wl = jax_get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    cfg = _cfg(wl, alg)
    w0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(cfg.seed)))
    stats, kw = {}, _stat_kw(alg)
    traj = _oracle_fn(jax_reference, alg)(
        model, cfg_model, wl.make_clients(5, n_per=60, seed=0), cfg,
        stats=stats, **ORACLES[alg][3], **kw)
    return w0, traj, stats, kw.get("losses")


def _port_oracle(name, alg, w0=None, **cfg_kw):
    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    stats, kw = {}, _stat_kw(alg)
    traj = _oracle_fn(reference, alg)(
        model, cfg_model, wl.make_clients(5, n_per=60, seed=0),
        _cfg(wl, alg, **cfg_kw), stats=stats, device="cpu",
        init_params=w0, **ORACLES[alg][3], **kw)
    return traj, stats, kw.get("losses")


def _close(got, want, tag=""):
    """Two {t: weights} trajectories: the same t, within tolerance."""
    assert sorted(got) == sorted(want) and len(got) >= 2, tag
    for t in want:
        assert set(got[t]) == set(want[t]), tag
        for k in want[t]:
            np.testing.assert_allclose(got[t][k], want[t][k], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{tag} {k} t={t}")


@pytest.mark.parametrize("name,alg", [
    ("lstm_regression", "asofed"), ("cnn_classification", "asofed"),
    ("lstm_multilabel", "asofed"), ("lstm_regression", "fedasync"),
    ("lstm_regression", "fedbuff"), ("lstm_regression", "fedavg"),
    ("lstm_regression", "fedprox"),
])
def test_port_oracle_matches_jax_oracle(name, alg):
    w0, jtraj, jstats, jlosses = _jax_oracle(name, alg)
    traj, stats, losses = _port_oracle(name, alg, w0)
    _close(traj, jtraj, f"{alg} {name}")
    # the host-side counters replay the same arrival stream exactly
    assert stats == jstats
    if jlosses is not None:
        assert sorted(losses) == sorted(jlosses)
        np.testing.assert_allclose([losses[t] for t in sorted(losses)],
                                   [jlosses[t] for t in sorted(jlosses)],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("alg,fold_mode,name", [
    ("asofed", "sequential", "lstm_regression"),
    ("asofed", "sequential", "cnn_classification"),
    ("fedasync", "associative", "lstm_regression"),
    ("fedavg", "sequential", "lstm_regression"),
])
def test_port_engine_matches_port_oracle(alg, fold_mode, name):
    """The port held to its own per-arrival loop, from its own seeded
    ``w0`` (no JAX draw involved)."""
    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    cfg = _cfg(wl, alg, fold_mode=fold_mode)
    trace, stats = [], {}
    run_strategy(get_strategy(alg), model, cfg_model,
                 wl.make_clients(5, n_per=60, seed=0), cfg, device="cpu",
                 trace=trace, stats=stats, window=4)
    assert stats["fold_mode"] == fold_mode
    traj, ostats, _ = _port_oracle(name, alg)
    assert stats["iters"] == max(traj)
    assert trace[-1][0] == max(traj) and len(trace) >= 2
    _close({t: w for t, w in trace}, {t: traj[t] for t, _ in trace},
           f"{alg} engine vs oracle")


def _jax_tree(w):
    return jax.tree.map(jnp.asarray, w)


@pytest.mark.parametrize("keep_copies", [True, False])
@pytest.mark.parametrize("feature_learning", [True, False])
@pytest.mark.parametrize("name", ["lstm_regression", "cnn_classification"])
def test_aggregate_matches_jax(keep_copies, feature_learning, name):
    jwl, wl = jax_get_workload(name), get_workload(name)
    jcm, jmodel = jwl.build(hidden=12)
    cm, _ = wl.build(hidden=12)
    rng = np.random.default_rng(3)
    w = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    # a client's new local model (paper mode) or its delta (delta mode)
    upload = {k: ((v if keep_copies else 0.0)
                  + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in w.items()}
    n_init = {0: 12.0, 1: 30.0, 2: 7.0}
    jstate = jax_server.init_server(_jax_tree(w), [0, 1, 2], n_init,
                                    keep_copies=keep_copies)
    state = server_lib.init_server(params_from_numpy(w, device="cpu"),
                                   [0, 1, 2], n_init,
                                   keep_copies=keep_copies)
    state0 = state
    n0, copies0 = dict(state0.n), dict(state0.copies)
    for cid, n_k in ((1, 33.0), (0, 15.0)):
        kw = dict(upload_is_delta=not keep_copies,
                  feature_learning=feature_learning)
        jstate = jax_server.aggregate(jstate, cid, _jax_tree(upload), n_k,
                                      jcm, **kw)
        state = server_lib.aggregate(
            state, cid, params_from_numpy(upload, device="cpu"), n_k, cm,
            **kw)
    # non-mutating: the input state and its dicts are untouched
    assert state0.t == 0 and state0.n == n0
    assert state0.copies.keys() == copies0.keys() and all(
        state0.copies[k] is copies0[k] for k in copies0)
    assert state.t == jstate.t == 2 and state.n == jstate.n
    for k, jv in jstate.w.items():
        jv = np.asarray(jv)
        err = float(np.abs(state.w[k].numpy() - jv).max())
        assert err <= AGG_TOL * max(1.0, float(np.abs(jv).max())), (k, err)
    if keep_copies:
        for cid in (0, 1):
            np.testing.assert_array_equal(
                state.copies[cid]["fc_w"].numpy(),
                np.asarray(jstate.copies[cid]["fc_w"]))


def test_client_step_matches_jax():
    """client_step / receive_server_model / local_delta on one client."""
    jwl = jax_get_workload("lstm_regression")
    wl = get_workload("lstm_regression")
    _, jmodel = jwl.build(hidden=12)
    _, model = wl.build(hidden=12)
    w = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    stream = wl.make_clients(2, n_per=60, seed=0)[0].stream
    x, y = stream.x[:8], stream.y[:8]
    jst = jax_client.init_client_state(_jax_tree(w), 20.0)
    st = client_lib.init_client_state(params_from_numpy(w, device="cpu"),
                                      20.0)
    kw = dict(lam=1.0, beta=0.001, eta=0.02)
    for delay, new in ((35.0, 2.0), (80.0, 0.0)):
        jbefore, before = jst, st
        jst, jm = jax_client.client_step(
            jmodel.loss, jst, {"x": jnp.asarray(x), "y": jnp.asarray(y),
                               "task": "regression"},
            delay=delay, new_samples=new, **kw)
        st, m = client_lib.client_step(
            model.loss, st, {"x": torch.tensor(x), "y": torch.tensor(y),
                             "task": "regression"},
            delay=delay, new_samples=new, **kw)
        for key in ("loss", "r_mult", "step"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       atol=ATOL, rtol=RTOL, err_msg=key)
        jd = jax_client.local_delta(jbefore, jst)
        d = client_lib.local_delta(before, st)
        for k in jd:
            np.testing.assert_allclose(d[k].numpy(), np.asarray(jd[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
    assert float(st.rounds) == 2.0 and float(st.n_samples) == 22.0
    server_w = tree_map(lambda v: v + 1.0, st.params)
    got = client_lib.receive_server_model(st, server_w)
    assert got.params is server_w and got.server_params is server_w
    assert got.v is st.v and st.params is not server_w


@pytest.mark.parametrize("cfg_kw,knob", [
    (dict(upload_codec="topk_sparse"), "upload_codec"),
    # the state codecs are ported (tests/test_torch_state_pool.py): an
    # unknown state dtype still raises, with the JAX package's message
    pytest.param(dict(state_dtype="int3"), "unknown state dtype 'int3'",
                 id="cfg_kw1-state_dtype"),
    (dict(max_staleness=4.0), "max_staleness"),
    (dict(max_delta_norm=1.0), "max_delta_norm"),
    (None, "faults"),
])
@pytest.mark.parametrize("alg", ["asofed", "fedasync", "fedbuff", "fedavg"])
def test_oracle_knobs_outside_the_slice_raise(alg, cfg_kw, knob):
    from repro_torch.sim.faults import FaultSpec

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=4)
    clients = wl.make_clients(3, n_per=20, seed=0)
    if cfg_kw is None:
        clients[1].profile = dataclasses.replace(
            clients[1].profile, faults=FaultSpec.uniform(0.2))
    with pytest.raises(ValueError, match=knob):
        _oracle_fn(reference, alg)(model, cfg_model, clients,
                                   _cfg(wl, alg, **(cfg_kw or {})),
                                   device="cpu")


@pytest.mark.parametrize("alg", ["asofed", "fedasync", "fedbuff", "fedavg"])
def test_oracles_default_to_the_card(alg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=4)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        _oracle_fn(reference, alg)(model, cfg_model,
                                   wl.make_clients(3, n_per=20, seed=0),
                                   _cfg(wl, alg))
