"""Checkpoints and crash-resume of the port's cohort engine
(``repro_torch.checkpoint``, ``run_strategy(checkpoint_path=,
checkpoint_every=, resume_from=)``), against its own uninterrupted runs
and across packages.

1. The JAX package's cases (``tests/test_checkpoint_resume.py`` and the
   crash-resume cases of ``tests/test_state_pool.py``) under the same
   names on the port: checkpointing leaves the trajectory bit for bit as
   it was, a resume lands on the uninterrupted run's final weights bit
   for bit, and the fail-fast seams raise the JAX package's messages.
2. The port's own resume cases, all bitwise: fedasync and fedbuff on the
   associative fold, int8 / int4 stacked state, prefetch on and off, an
   upload codec, host residency under faults.
3. Across packages: a snapshot the JAX engine wrote resumes in the port,
   and one the port wrote resumes in the JAX engine, each landing within
   the engine-vs-oracle tolerance of ``tests/test_sim_engine.py`` (atol
   3e-4, rtol 3e-3) of the writer's uninterrupted run; a bf16 ``stacked``
   directory loads bit for bit in either package.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.core import RunConfig as JaxRunConfig  # noqa: E402
from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint, load_run_state,  # noqa: E402
                                    save_checkpoint, save_run_state)
from repro_torch.common.pytree import tree_flatten_with_path  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.sim.engine import RunConfig, run_strategy  # noqa: E402

ATOL, RTOL = 3e-4, 3e-3


@functools.lru_cache(maxsize=1)
def _setup():
    """The JAX tests' setup on the port: (data, cfg_model, model)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import airquality_like
    from repro_torch.models import build_model

    data = airquality_like(n_clients=5, n_per=60)
    cfg_model = dataclasses.replace(get_arch("paper-lstm"), in_features=8,
                                    out_features=1, hidden=12)
    return data, cfg_model, build_model(cfg_model)


@functools.lru_cache(maxsize=1)
def _jax_setup():
    from repro.configs import get_arch
    from repro.data import airquality_like
    from repro.models import LOCAL, build_model

    data = airquality_like(n_clients=5, n_per=60)
    cfg_model = dataclasses.replace(get_arch("paper-lstm"), in_features=8,
                                    out_features=1, hidden=12)
    model = build_model(cfg_model, LOCAL)
    return data, cfg_model, model, jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(0)))


_CFG = dict(T=60, batch_size=8, local_epochs=2, eta=0.02, lam=1.0,
            beta=0.001, task="regression", eval_every=20)


def _cfg(**kw):
    kw.setdefault("seed", 0)
    return RunConfig(**_CFG, **kw)


def _clients(fault_rate=0.0, package="port"):
    if package == "port":
        from repro_torch.sim.profiles import make_sim_clients

        data = _setup()[0]
    else:
        from repro.sim.profiles import make_sim_clients

        data = _jax_setup()[0]
    if fault_rate:
        return make_sim_clients(data, seed=0, fault_rate=fault_rate,
                                fault_seed=42)
    return make_sim_clients(data, seed=0)


def _run(alg, cfg, fault_rate, window, **kw):
    """(trace, stats) of the port's engine on the CPU."""
    _, cfg_model, model = _setup()
    trace, stats = [], {}
    run_strategy(get_strategy(alg), model, cfg_model, _clients(fault_rate),
                 cfg, trace=trace, stats=stats, window=window, device="cpu",
                 **kw)
    return trace, stats


def _jax_run(alg, cfg_kw, fault_rate, **kw):
    """(trace, stats) of the JAX engine."""
    _, cfg_model, model, _ = _jax_setup()
    trace, stats = [], {}
    jax_run_strategy(jax_get_strategy(alg), model, cfg_model,
                     _clients(fault_rate, "jax"),
                     JaxRunConfig(**_CFG, seed=0, **cfg_kw), trace=trace,
                     stats=stats, **kw)
    return trace, stats


def _assert_final_bitwise(tr_res, tr_full):
    assert tr_res[-1][0] == tr_full[-1][0]
    for k in tr_full[-1][1]:
        np.testing.assert_array_equal(tr_res[-1][1][k], tr_full[-1][1][k],
                                      err_msg=f"resumed weights differ: {k}")


def _check_bitwise_resume(alg, fault_rate, window, tmp_path, run_kw=None,
                          **cfg_kw):
    run_kw = run_kw or {}
    cfg = _cfg(**cfg_kw)
    d = str(tmp_path / "snap")
    tr_full, _ = _run(alg, cfg, fault_rate, window, **run_kw)
    tr_ckpt, st_ckpt = _run(alg, cfg, fault_rate, window,
                            checkpoint_path=d, checkpoint_every=20, **run_kw)
    tr_res, st_res = _run(alg, cfg, fault_rate, window, resume_from=d,
                          **run_kw)

    # the checkpointing run is bit for bit the plain run
    assert len(tr_ckpt) == len(tr_full)
    for (ta, wa), (tf, wf) in zip(tr_ckpt, tr_full):
        assert ta == tf
        for k in wf:
            np.testing.assert_array_equal(
                wa[k], wf[k], err_msg=f"snapshotting perturbed the run at "
                                      f"t={ta}")
    assert st_ckpt["ckpt_writes"] >= 1 and st_ckpt["ckpt_bytes"] > 0
    # the resumed run lands on the uninterrupted final weights, bitwise
    assert 0 < st_res["resumed_from_t"] < cfg.T
    _assert_final_bitwise(tr_res, tr_full)
    return st_ckpt, st_res


# ---------------------------------------------------------------------------
# The JAX package's cases (tests/test_checkpoint_resume.py), on the port
# ---------------------------------------------------------------------------


def test_resume_bitwise_fault_free(tmp_path):
    _check_bitwise_resume("asofed", 0.0, 1, tmp_path)


def test_resume_bitwise_under_faults(tmp_path):
    _check_bitwise_resume("asofed", 0.15, 1, tmp_path,
                          max_staleness=8.0, max_delta_norm=0.5)


@pytest.mark.slow
def test_resume_bitwise_megastep_window(tmp_path):
    _check_bitwise_resume("fedasync", 0.15, 4, tmp_path,
                          max_staleness=8.0, max_delta_norm=0.5)


@pytest.mark.slow
def test_resume_bitwise_bf16_state(tmp_path):
    _check_bitwise_resume("fedbuff", 0.15, 1, tmp_path,
                          state_dtype="bf16", max_delta_norm=0.5)


def test_resume_strategy_mismatch_raises(tmp_path):
    d = str(tmp_path / "snap")
    _run("asofed", _cfg(), 0.0, 1, checkpoint_path=d, checkpoint_every=20)
    with pytest.raises(ValueError, match="strategy"):
        _run("fedasync", _cfg(), 0.0, 1, resume_from=d)


def test_resume_seed_mismatch_raises(tmp_path):
    d = str(tmp_path / "snap")
    _run("asofed", _cfg(), 0.0, 1, checkpoint_path=d, checkpoint_every=20)
    with pytest.raises(ValueError, match="seed"):
        _run("asofed", _cfg(seed=1), 0.0, 1, resume_from=d)


@pytest.mark.parametrize("alg", ["fedavg", "local"])
def test_checkpoint_requires_async_schedule(alg, tmp_path):
    with pytest.raises(ValueError, match="async"):
        _run(alg, _cfg(), 0.0, 1, checkpoint_path=str(tmp_path / "s"))
    with pytest.raises(ValueError, match="async"):
        _run(alg, _cfg(), 0.0, 1, resume_from=str(tmp_path / "s"))


def test_half_written_snapshot_refuses_to_load(tmp_path):
    # run.json is written last through an atomic rename: a directory
    # without it (a crash mid-write) never loads as a valid snapshot
    d = str(tmp_path / "snap")
    save_run_state(d, {"w": torch.zeros(3)}, {"s": torch.ones(2)}, {"t": 4})
    os.remove(os.path.join(d, "run.json"))
    with pytest.raises(FileNotFoundError, match="run.json"):
        load_run_state(d, {"w": torch.zeros(3)}, {"s": torch.ones(2)})


def test_run_state_round_trip(tmp_path):
    host = {"t": 7, "sim_time": 123.5, "strategy": "asofed"}
    stacked = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    server = {"s": torch.full((4,), 2.5)}
    save_run_state(str(tmp_path), stacked, server, host)
    st2, sv2, h2 = load_run_state(str(tmp_path), stacked, server)
    assert {k: h2[k] for k in host} == host
    assert torch.equal(st2["w"], stacked["w"])
    assert torch.equal(sv2["s"], server["s"])


def test_snapshot_overwrite_is_crash_consistent(tmp_path):
    # payloads land under fresh step-tagged directories; run.json flips
    # atomically and names its directories — so a crash midway through
    # snapshot N+1 (half-written directories, run.json never flipped)
    # still loads N
    d = str(tmp_path / "snap")
    stacked = {"w": torch.zeros(3)}
    server = {"s": torch.ones(2)}
    save_run_state(d, stacked, server, {"t": 10})
    os.makedirs(os.path.join(d, f"stacked-{20:012d}"))  # torn write of t=20
    st, sv, host = load_run_state(d, stacked, server)
    assert host["t"] == 10
    assert torch.equal(st["w"], stacked["w"])
    # a completed second snapshot removes the superseded directories
    save_run_state(d, {"w": torch.full((3,), 2.0)}, server, {"t": 20})
    names = set(os.listdir(d))
    assert f"stacked-{10:012d}" not in names
    assert f"server-{10:012d}" not in names
    _, _, host = load_run_state(d, stacked, server)
    assert host["t"] == 20


def _two_leaves():
    return {"alpha": torch.zeros(2), "beta": torch.ones(3)}


def test_load_checkpoint_reports_readable_key_diff(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, _two_leaves())
    with pytest.raises(ValueError) as ei:
        load_checkpoint(d, {"alpha": torch.zeros(2),
                            "gamma": torch.ones(3)})
    msg = str(ei.value)
    assert "beta" in msg and "gamma" in msg
    assert "not in target" in msg and "not in checkpoint" in msg


def test_load_checkpoint_reports_key_order_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, _two_leaves())
    mpath = os.path.join(d, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["keys"] = list(reversed(manifest["keys"]))
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="different order"):
        load_checkpoint(d, _two_leaves())


def test_load_checkpoint_detects_truncated_npz(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, _two_leaves())
    np.savez(os.path.join(d, "params.npz"), arr_0=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="corrupt checkpoint at .*: "
                       "manifest lists 2 arrays but params.npz holds 1"):
        load_checkpoint(d, _two_leaves())


def test_checkpoint_round_trips_bf16_bitwise(tmp_path):
    # numpy has no bf16: the leaf is written as its int16 patterns under
    # the manifest dtype "bfloat16" and viewed back exactly
    d = str(tmp_path / "ck")
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((4, 3), generator=gen).to(torch.bfloat16),
            "b": torch.randn((3,), generator=gen)}
    save_checkpoint(d, tree, step=3)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["dtypes"] == ["float32", "bfloat16"]
    out, step = load_checkpoint(d, tree)
    assert step == 3
    for k in tree:
        assert out[k].dtype == tree[k].dtype
        assert torch.equal(out[k].view(torch.int16) if k == "w" else out[k],
                           tree[k].view(torch.int16) if k == "w"
                           else tree[k])


def test_checkpoint_round_trips_every_state_dtype_and_shape(tmp_path):
    """The stored state's other leaf types (fp32, fp16, int8 codes, uint8,
    int32 counts) and 0-d scalars (fedbuff's ``count``) come back with
    their dtype and shape, bit for bit, and load in the JAX package too."""
    d = str(tmp_path / "ck")
    gen = torch.Generator().manual_seed(1)
    tree = {"count": torch.tensor(3.0),
            "h": torch.randn((2, 3), generator=gen).to(torch.float16),
            "q": torch.randint(-7, 8, (4,), generator=gen,
                               dtype=torch.int8),
            "u": torch.randint(0, 255, (5,), generator=gen,
                               dtype=torch.uint8),
            "n": torch.arange(3, dtype=torch.int32),
            "w": torch.randn((3, 2), generator=gen)}
    save_checkpoint(d, tree, step=9)
    out, step = load_checkpoint(d, tree)
    jout, jstep = jax_load_checkpoint(d, {k: np.asarray(v.numpy())
                                          for k, v in tree.items()})
    assert step == jstep == 9
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert torch.equal(out[k], v), k
        np.testing.assert_array_equal(np.asarray(jout[k]), v.numpy())


# ---------------------------------------------------------------------------
# The JAX package's host-residency cases (tests/test_state_pool.py)
# ---------------------------------------------------------------------------


def _pool_run(cfg, **kw):
    from repro_torch.sim.workloads import get_workload

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build()
    tr = []
    run_strategy(get_strategy("asofed"), model, cfg_model,
                 wl.make_clients(8, seed=0), cfg, trace=tr, device="cpu",
                 **kw)
    return tr


def _pool_cfg(**kw):
    from repro_torch.sim.workloads import get_workload

    kw.setdefault("window", 4)
    kw.setdefault("eval_every", 12)
    return get_workload("lstm_regression").run_config(
        T=24, batch_size=4, local_epochs=1, eta=0.02, lam=1.0, beta=0.001,
        seed=0, **kw)


def test_crash_resume_host_residency_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    cfg = dataclasses.replace(_pool_cfg(state_dtype="int8"),
                              state_residency="host", state_shards=2)
    tr_full = _pool_run(cfg)
    _pool_run(dataclasses.replace(cfg, T=12), checkpoint_path=ck,
              checkpoint_every=8)
    tr_res = _pool_run(cfg, resume_from=ck)
    full = {t: w for t, w in tr_full}
    post = [(t, w) for t, w in tr_res if t in full]
    assert post, "resume replayed no post-checkpoint windows"
    for t, w in post:
        for k in w:
            np.testing.assert_array_equal(full[t][k], w[k])


def test_residency_mismatch_fails_readably(tmp_path):
    host_ck = str(tmp_path / "host_ck")
    dev_ck = str(tmp_path / "dev_ck")
    hcfg = dataclasses.replace(_pool_cfg(), T=12, state_residency="host")
    _pool_run(hcfg, checkpoint_path=host_ck, checkpoint_every=8)
    _pool_run(dataclasses.replace(hcfg, state_residency="device"),
              checkpoint_path=dev_ck, checkpoint_every=8)
    with pytest.raises(ValueError, match="state-residency mismatch"):
        _pool_run(_pool_cfg(), resume_from=host_ck)
    with pytest.raises(ValueError, match="state-residency mismatch"):
        _pool_run(hcfg, resume_from=dev_ck)


# ---------------------------------------------------------------------------
# The port's own resume cases, all bit for bit
# ---------------------------------------------------------------------------

PORT_CASES = {
    "fedasync-associative": ("fedasync", 0.0, 1, {}, dict(
        fold_mode="associative")),
    "fedbuff-associative": ("fedbuff", 0.0, 1, {}, dict(
        fold_mode="associative", buffer_size=3)),
    "fedasync-associative-faults-window4": ("fedasync", 0.15, 4, {}, dict(
        fold_mode="associative", max_staleness=8.0, max_delta_norm=0.5)),
    "fedbuff-faults": ("fedbuff", 0.15, 1, {}, dict(max_delta_norm=0.5)),
    "asofed-int8": ("asofed", 0.0, 1, {}, dict(state_dtype="int8")),
    "asofed-int4-faults": ("asofed", 0.15, 1, {}, dict(
        state_dtype="int4", max_delta_norm=0.5)),
    "asofed-bf16-window4": ("asofed", 0.0, 4, {}, dict(state_dtype="bf16")),
    "asofed-prefetch-on": ("asofed", 0.0, 4, dict(prefetch=True), {}),
    "asofed-prefetch-off": ("asofed", 0.0, 4, dict(prefetch=False), {}),
    "asofed-random-mask": ("asofed", 0.0, 1, {}, dict(
        upload_codec="random_mask", upload_frac=0.25)),
    "fedasync-quantized-delta-faults": ("fedasync", 0.15, 1, {}, dict(
        upload_codec="quantized_delta", upload_bits=4, max_staleness=8.0,
        staleness_policy="downweight")),
    "asofed-host-int8-faults": ("asofed", 0.15, 4, {}, dict(
        state_residency="host", state_dtype="int8", max_delta_norm=0.5)),
    "fedasync-host-associative": ("fedasync", 0.0, 4, {}, dict(
        state_residency="host", fold_mode="associative")),
    "asofed-host-bf16": ("asofed", 0.0, 1, {}, dict(
        state_residency="host", state_dtype="bf16")),
}


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_port_resume_bitwise(case, tmp_path):
    alg, rate, window, run_kw, cfg_kw = PORT_CASES[case]
    st_ckpt, _ = _check_bitwise_resume(alg, rate, window, tmp_path,
                                       run_kw=run_kw, **cfg_kw)
    assert st_ckpt["ckpt_write_s"] > 0.0


def test_checkpoint_interval_and_eval_cadence(tmp_path):
    """``checkpoint_every`` sets the snapshot interval (default
    ``eval_every``); the last snapshot written is the one resumed, only
    its directories remain, and the resumed run's evaluations continue
    the plain run's cadence (here the final one at T) on its weights."""
    d = str(tmp_path / "snap")
    cfg = _cfg()
    tr_full, _ = _run("asofed", cfg, 0.0, 1)
    _, st = _run("asofed", cfg, 0.0, 1, checkpoint_path=d)
    assert st["ckpt_writes"] == 2  # the windows starting at t >= 20, 40
    _, st = _run("asofed", cfg, 0.0, 1, checkpoint_path=d,
                 checkpoint_every=7)
    with open(os.path.join(d, "run.json")) as f:
        host = json.load(f)
    assert st["ckpt_writes"] >= 5 and host["t"] >= 49
    assert sorted(n.split("-")[0] for n in os.listdir(d) if "-" in n) == [
        "server", "stacked"]
    trace = []
    hist = run_strategy(get_strategy("asofed"), _setup()[2], _setup()[1],
                        _clients(), cfg, device="cpu", resume_from=d,
                        trace=trace)
    assert [h.global_iter for h in hist] == [60]
    _assert_final_bitwise(trace, tr_full)


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

CROSS_CASES = {
    "asofed-fp32": ("asofed", 0.0, {}),
    "asofed-faults": ("asofed", 0.15, dict(max_staleness=8.0,
                                           max_delta_norm=0.5)),
    "fedbuff-bf16": ("fedbuff", 0.0, dict(state_dtype="bf16")),
    "asofed-host-int8": ("asofed", 0.0, dict(state_residency="host",
                                             state_dtype="int8")),
}


def _close(got, want, tag):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_jax_snapshot_resumes_in_port(case, tmp_path):
    alg, rate, cfg_kw = CROSS_CASES[case]
    d = str(tmp_path / "snap")
    tr_full, _ = _jax_run(alg, cfg_kw, rate)
    _jax_run(alg, cfg_kw, rate, checkpoint_path=d, checkpoint_every=20)
    w0 = _jax_setup()[3]
    tr_res, st = _run(alg, _cfg(**cfg_kw), rate, 1, resume_from=d,
                      init_params=w0)
    assert 0 < st["resumed_from_t"] < _CFG["T"]
    assert tr_res[-1][0] == tr_full[-1][0]
    _close(tr_res[-1][1], tr_full[-1][1], f"{case}: port resumed JAX's")


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_port_snapshot_resumes_in_jax(case, tmp_path):
    alg, rate, cfg_kw = CROSS_CASES[case]
    d = str(tmp_path / "snap")
    w0 = _jax_setup()[3]
    cfg = _cfg(**cfg_kw)
    tr_full, _ = _run(alg, cfg, rate, 1, init_params=w0)
    _run(alg, cfg, rate, 1, init_params=w0, checkpoint_path=d,
         checkpoint_every=20)
    tr_res, st = _jax_run(alg, cfg_kw, rate, resume_from=d)
    assert 0 < st["resumed_from_t"] < _CFG["T"]
    assert tr_res[-1][0] == tr_full[-1][0]
    _close(jax.tree.map(np.asarray, tr_res[-1][1]), tr_full[-1][1],
           f"{case}: JAX resumed the port's")


def test_jax_bf16_host_snapshot_resumes_in_port(tmp_path):
    """The JAX package writes a bf16 pool leaf with ``np.save`` as raw
    ``|V2`` bytes, which its own ``HostStatePool.load_flat`` refuses
    (``|V2`` is not ``bfloat16``; ROADMAP §3).  The port reads those
    bytes as its pool's int16 patterns and resumes."""
    d = str(tmp_path / "snap")
    cfg_kw = dict(state_residency="host", state_dtype="bf16")
    tr_full, _ = _jax_run("asofed", cfg_kw, 0.0)
    _jax_run("asofed", cfg_kw, 0.0, checkpoint_path=d, checkpoint_every=20)
    with pytest.raises(ValueError, match="expected .*bfloat16"):
        _jax_run("asofed", cfg_kw, 0.0, resume_from=d)
    tr_res, st = _run("asofed", _cfg(**cfg_kw), 0.0, 1, resume_from=d,
                      init_params=_jax_setup()[3])
    assert 0 < st["resumed_from_t"] < _CFG["T"]
    assert tr_res[-1][0] == tr_full[-1][0]
    _close(tr_res[-1][1], tr_full[-1][1], "port resumed JAX's bf16 pool")


def _stacked_dir(d):
    (name,) = [n for n in os.listdir(d) if n.startswith("stacked-")]
    return os.path.join(d, name)


def test_bf16_stacked_loads_bitwise_across_packages(tmp_path):
    """fedbuff's bf16 ``stacked-*`` directory, written by each engine,
    loads bit for bit in the other package's ``load_checkpoint``, with
    the same keys and the manifest dtype ``bfloat16``."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    cfg_kw = dict(state_dtype="bf16")
    _jax_run("fedbuff", cfg_kw, 0.0, checkpoint_path=jd, checkpoint_every=20)
    _run("fedbuff", _cfg(**cfg_kw), 0.0, 1, init_params=_jax_setup()[3],
         checkpoint_path=td, checkpoint_every=20)
    with open(os.path.join(_stacked_dir(jd), "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(_stacked_dir(td), "manifest.json")) as f:
        tm = json.load(f)
    assert jm["keys"] == tm["keys"] and jm["dtypes"] == tm["dtypes"]
    assert "bfloat16" in tm["dtypes"]
    for src in (jd, td):
        path = _stacked_dir(src)
        jtree, _ = jax_load_checkpoint(path, _like_jax(path))
        ttree, _ = load_checkpoint(path, _like_port(path))
        jl = [np.asarray(x) for x in jax.tree.leaves(jtree)]
        tl = [v for _, v in tree_flatten_with_path(ttree)]
        assert len(jl) == len(tl) == len(jm["keys"])
        for a, b, dt in zip(jl, tl, jm["dtypes"]):
            if dt == "bfloat16":
                assert b.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    a.view(np.int16), b.view(torch.int16).numpy())
            else:
                np.testing.assert_array_equal(a, b.numpy())


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _like_port(path):
    """A port tree with the manifest's keys (fedbuff's dict state)."""
    m = _manifest(path)
    tree = {}
    for key, dt in zip(m["keys"], m["dtypes"]):
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.zeros(
            (), dtype=torch.bfloat16 if dt == "bfloat16" else torch.float32)
    return tree


def _like_jax(path):
    m = _manifest(path)
    tree = {}
    for key in m["keys"]:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros((), np.float32)
    return tree


def test_flatten_with_path_prints_the_jax_keys():
    """The port's path flatten names a ``ClientState`` under a dict as the
    JAX package's checkpoint keys do: dict keys sorted, dataclass fields
    as ``.name`` in declaration order."""
    from repro.checkpoint.checkpoint import _flatten as jax_flatten
    from repro.core.client import init_client_state as jax_init
    from repro_torch.core.client import init_client_state

    w = {"w_x": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)}
    jkeys, _, _ = jax_flatten({"version": np.float32(0),
                               "stacked": jax_init(w, 1.0)})
    tstate = init_client_state({k: torch.tensor(v) for k, v in w.items()},
                               1.0)
    tkeys = ["/".join(p) for p, _ in tree_flatten_with_path(
        {"version": torch.zeros(()), "stacked": tstate})]
    assert tkeys == jkeys
    assert tkeys[0] == "stacked/.params/b" and tkeys[-1] == "version"


def test_snapshot_bytes_count_the_snapshot_only(tmp_path):
    # save_run_state reports the bytes it wrote: an unrelated file the
    # user keeps beside the snapshot and the superseded snapshot it
    # removes are not counted
    d = str(tmp_path / "snap")
    os.makedirs(d)
    with open(os.path.join(d, "notes.bin"), "wb") as f:
        f.write(b"\0" * 100_000)
    server = {"s": torch.ones(2)}
    save_run_state(d, {"w": torch.zeros(3)}, server, {"t": 10})
    nbytes = save_run_state(d, {"w": torch.zeros(5000)}, server, {"t": 20})
    tag = f"{20:012d}"
    want = os.path.getsize(os.path.join(d, "run.json")) + sum(
        os.path.getsize(os.path.join(d, sub, f))
        for sub in (f"stacked-{tag}", f"server-{tag}")
        for f in os.listdir(os.path.join(d, sub)))
    assert nbytes == want and 20_000 < nbytes < 100_000
