"""The port's chaos layer against the JAX package's engine and the port's
own oracles: crash-restart, wire corruption, duplicate delivery and the
server's admission guards (``max_staleness``, ``max_delta_norm``).

The counterparts of ``tests/test_faults.py``'s engine-vs-oracle pins:
every run starts both packages from the JAX package's ``w0`` and replays
the same faulty arrival stream (the fault pipeline is the shared host
layer), and trajectories are held at every tick boundary to the
engine-vs-oracle tolerance of ``tests/test_sim_engine.py``; the fault
and admission counters must equal the JAX engine's.  Then the port's own
bitwise contracts under faults (host vs device residency, window size,
prefetch), the gating contract (a run with no faults, no guards and the
identity codec executes no op of the layer) and the fault-aware fold
mode resolution.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim import faults as jax_faults  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.sim import faults  # noqa: E402
from repro_torch.sim import reference  # noqa: E402
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

# the engine-vs-oracle tolerance of tests/test_sim_engine.py
ATOL, RTOL = 3e-4, 3e-3
NAME = "lstm_regression"
GUARDS = (("max_delta_norm", 0.5), ("max_staleness", 8.0))
# fault specs by name: tests/test_faults.py's mixed spec and per-kind ones
SPECS = {
    "mixed": lambda m: m.FaultSpec.uniform(0.15, seed=42, corrupt_kind="nan"),
    "loss": lambda m: m.FaultSpec(seed=42, p_loss=0.3),
    "duplicate": lambda m: m.FaultSpec(seed=42, p_duplicate=0.3),
    "corrupt-nan": lambda m: m.FaultSpec(seed=42, p_corrupt=0.3,
                                         corrupt_kind="nan"),
    "corrupt-noise": lambda m: m.FaultSpec(seed=42, p_corrupt=0.3,
                                           corrupt_kind="noise"),
    "crash": lambda m: m.FaultSpec(seed=42, p_crash=0.3),
}
COUNTERS = ("lost_uploads", "retried_uploads", "crashed_clients",
            "duplicated_arrivals", "corrupted_arrivals", "rejected_uploads",
            "clipped_uploads")


def _cfg(wl, cfg_kw):
    return wl.run_config(T=60, batch_size=8, local_epochs=2, eta=0.02,
                         lam=1.0, beta=0.001, eval_every=30, seed=0,
                         **dict(cfg_kw))


def _clients(wl, mod, spec):
    cs = wl.make_clients(5, n_per=60, seed=0)
    return mod.with_faults(cs, [SPECS[spec](mod)] * len(cs))


@functools.lru_cache(maxsize=None)
def _jax(alg, spec, cfg_kw):
    """(w0, trace, stats) of the JAX engine."""
    wl = jax_get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    cfg = _cfg(wl, cfg_kw)
    w0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(cfg.seed)))
    trace, stats = [], {}
    jax_run_strategy(jax_get_strategy(alg), model, cfg_model,
                     _clients(wl, jax_faults, spec), cfg, trace=trace,
                     stats=stats)
    return w0, trace, stats


def _port(alg, spec, cfg_kw, **run_kw):
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    trace, stats = [], {}
    run_strategy(get_strategy(alg), model, cfg_model,
                 _clients(wl, faults, spec), _cfg(wl, cfg_kw), device="cpu",
                 init_params=_jax(alg, spec, cfg_kw)[0], trace=trace,
                 stats=stats, **run_kw)
    return trace, stats


def _oracle(alg, spec, cfg_kw):
    """(trajectory, stats) of the port's oracle."""
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    cfg = _cfg(wl, dict(cfg_kw, fold_mode="sequential"))
    stats = {}
    traj = getattr(reference, f"run_{alg}_reference")(
        model, cfg_model, _clients(wl, faults, spec), cfg, device="cpu",
        init_params=_jax(alg, spec, cfg_kw)[0], stats=stats)
    return traj, stats


def _close(trace, ref, tag):
    ref = dict(ref)
    assert trace and trace[-1][0] in ref, tag
    for t, w in trace:
        assert t in ref, f"{tag}: boundary t={t} not in the reference"
        for k in w:
            assert np.all(np.isfinite(w[k])), f"{tag} {k} at t={t}"
            np.testing.assert_allclose(w[k], np.asarray(ref[t][k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{tag} {k} at t={t}")


def _check(alg, spec, **cfg_kw):
    """The port's engine against the JAX engine and the port's oracle,
    and its counters against the JAX engine's; returns the port's
    stats."""
    key = tuple(sorted(cfg_kw.items()))
    _, jtrace, jstats = _jax(alg, spec, key)
    trace, stats = _port(alg, spec, key)
    assert [t for t, _ in trace] == [t for t, _ in jtrace]
    _close(trace, jtrace, f"{alg} {spec} vs the jax engine")
    traj, ostats = _oracle(alg, spec, key)
    _close(trace, traj, f"{alg} {spec} vs the oracle")
    for c in COUNTERS:
        assert stats[c] == jstats[c], (c, stats[c], jstats[c])
    for c in ("rejected_uploads", "clipped_uploads"):
        assert ostats[c] == stats[c], (c, ostats[c], stats[c])
    if alg == "asofed":  # one server fold an admitted arrival, two a dup
        assert ostats["folds"] >= ostats["iters"] - ostats[
            "rejected_uploads"]
    return stats


@pytest.mark.parametrize("alg", ["asofed", "fedasync", "fedbuff"])
def test_engine_matches_jax_and_oracle_under_mixed_faults(alg):
    stats = _check(alg, "mixed", **dict(GUARDS))
    # the mixed spec exercises every branch of the layer
    assert stats["rejected_uploads"] > 0 and stats["clipped_uploads"] > 0
    assert stats["crashed_clients"] > 0 and stats["duplicated_arrivals"] > 0


def test_associative_fold_under_faults():
    # admission and duplicates composed into the affine coefficients
    # (a' = a^2, b' = a b + b) before the prefix scan
    stats = _check("fedasync", "mixed", fold_mode="associative",
                   **dict(GUARDS))
    assert stats["fold_mode"] == "associative"


def test_downweight_policy():
    _check("fedasync", "mixed", max_staleness=6.0,
           staleness_policy="downweight")


def test_asofed_f_associative_under_faults():
    stats = _check("asofed", "mixed", feature_learning=False,
                   fold_mode="associative", **dict(GUARDS))
    assert stats["fold_mode"] == "associative"


@pytest.mark.slow
@pytest.mark.parametrize("spec", ["loss", "duplicate", "corrupt-nan",
                                  "corrupt-noise", "crash"])
def test_engine_matches_jax_and_oracle_per_fault_kind(spec):
    _check("asofed", spec, **dict(GUARDS))


def _own_run(alg, **kw):
    """(trace, stats) of a port run under fault_rate=0.3 with the guards,
    its knobs passed to run_strategy."""
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    cfg_kw = {"max_staleness": 8.0, "max_delta_norm": 0.5}
    cfg_kw.update(kw.pop("cfg_kw", {}))
    trace, stats = [], {}
    run_strategy(get_strategy(alg), model, cfg_model,
                 wl.make_clients(5, n_per=60, seed=0, fault_rate=0.3,
                                 fault_seed=7),
                 wl.run_config(T=48, batch_size=8, local_epochs=2, eta=0.02,
                               eval_every=0, seed=0, **cfg_kw),
                 device="cpu", trace=trace, stats=stats, **kw)
    return trace, stats


def _bitwise(tr_a, tr_b):
    assert [t for t, _ in tr_a] == [t for t, _ in tr_b] and tr_a
    for (_, wa), (_, wb) in zip(tr_a, tr_b):
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


@pytest.mark.parametrize("alg,state_dtype", [("asofed", None),
                                             ("asofed", "int8"),
                                             ("fedasync", "bf16")])
def test_host_matches_device_bitwise_under_faults(alg, state_dtype):
    """A crashed row is rebuilt and encoded at the write-back like any
    other, so the host pool replays the device stack bit for bit."""
    kw = {"state_dtype": state_dtype}
    dev_tr, dev_stats = _own_run(alg, window=4, cfg_kw=kw)
    host_tr, host_stats = _own_run(
        alg, window=4, cfg_kw=dict(kw, state_residency="host"))
    assert host_stats["state_residency"] == "host"
    assert dev_stats["crashed_clients"] > 0
    _bitwise(host_tr, dev_tr)
    for c in COUNTERS:
        assert host_stats[c] == dev_stats[c], c


@pytest.mark.parametrize("alg", ["asofed", "fedbuff"])
def test_window_and_prefetch_bitwise_under_faults(alg):
    ref, _ = _own_run(alg, window=1, prefetch=False)
    _bitwise(_own_run(alg, window=1, prefetch=True)[0], ref)
    # window 4 reports every fourth tick's boundary: compare there
    w4, _ = _own_run(alg, window=4, prefetch=True)
    ref_at = dict(ref)
    assert w4 and all(t in ref_at for t, _ in w4)
    _bitwise(w4, [(t, ref_at[t]) for t, _ in w4])


def test_fault_free_run_executes_no_chaos_op(monkeypatch):
    """The gating contract: with no faults, no guards and the identity
    codec the tick runs the ops it ran before the chaos layer existed —
    none of the layer's helpers is called, no admission slot is added —
    and an all-zero FaultSpec changes nothing."""
    from repro_torch.common import prng
    from repro_torch.core.algorithms import common

    def boom(*a, **k):
        raise AssertionError("a chaos op ran in a fault-free tick")

    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=12)
    cfg = wl.run_config(T=30, batch_size=8, local_epochs=2, eta=0.02,
                        eval_every=0, seed=0, window=4)

    def run(alg, clients):
        trace, stats = [], {}
        run_strategy(get_strategy(alg), model, cfg_model, clients, cfg,
                     device="cpu", trace=trace, stats=stats)
        return trace, stats

    for alg in ("asofed", "fedasync", "fedbuff"):
        plain, _ = run(alg, wl.make_clients(5, n_per=60, seed=0))
        with monkeypatch.context() as m:
            for mod, names in ((prng, ("threefry2x32",)),
                               (common, ("admission", "corrupt_wire_delta",
                                         "upload_keys"))):
                for name in names:
                    m.setattr(mod, name, boom)
            inert = faults.with_faults(wl.make_clients(5, n_per=60, seed=0),
                                       [faults.FaultSpec(seed=3)] * 5)
            trace, stats = run(alg, inert)
        _bitwise(trace, plain)
        assert "rejected_uploads" not in stats
        assert stats["crashed_clients"] == stats["duplicated_arrivals"] == 0


def test_fedbuff_associative_under_faults_raises():
    from repro.sim.compile import resolve_fold_affine as jax_resolve
    from repro_torch.sim.compile import resolve_fold_affine

    jwl, wl = jax_get_workload(NAME), get_workload(NAME)
    jcm, jm = jwl.build(hidden=4)
    cm, m = wl.build(hidden=4)
    jcfg = jwl.run_config(fold_mode="associative", buffer_size=3)
    cfg = wl.run_config(fold_mode="associative", buffer_size=3)
    with pytest.raises(ValueError) as jerr:
        jax_resolve(jax_get_strategy("fedbuff"), jm, jcm, jcfg,
                    faults_on=True)
    with pytest.raises(ValueError) as err:
        resolve_fold_affine(get_strategy("fedbuff"), m, cm, cfg,
                            torch.device("cpu"), faults_on=True)
    assert str(err.value) == str(jerr.value)
    # ... through the engine too; under "auto" it folds sequentially
    with pytest.raises(ValueError, match="fold_affine_supports_faults"):
        run_strategy(get_strategy("fedbuff"), m, cm,
                     _clients(wl, faults, "mixed"), cfg, device="cpu")
    assert resolve_fold_affine(
        get_strategy("fedbuff"), m, cm,
        dataclasses.replace(cfg, fold_mode="auto"), torch.device("cuda"),
        faults_on=True) is None
