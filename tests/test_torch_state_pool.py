"""The port's host-resident client state (``repro_torch.sim.state_pool``)
and reduced-precision stored state in its engine and oracles, against
the JAX package.

1. ``HostStatePool`` against ``repro.sim.state_pool.HostStatePool``
   under one sequence of writes, gathers, scatters, patches and counter
   rollbacks: every stored byte equal (bf16 leaves as 16-bit patterns).
2. Residency: ``state_residency="host"`` replays the device-resident
   engine **bit for bit** inside the port, at every codec, window,
   prefetch setting and fold (the pool moves storage, not arithmetic).
3. The port's engine under bf16 / fp16 / int8 / int4 against the JAX
   engine, and the port's oracles at int8 against JAX's oracles and the
   port's host engine, within the engine-vs-oracle tolerance of
   ``tests/test_sim_engine.py`` (atol 3e-4, rtol 3e-3), from the JAX
   package's ``w0``; pool traffic counters equal to the JAX engine's.
4. The JAX engine's refusals, message for message.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.core.algorithms.fedasync import (  # noqa: E402
    FedAsyncStrategy as JaxFedAsync)
from repro.sim import reference as jax_reference  # noqa: E402
from repro.sim import state_pool as jax_pool  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.core.algorithms.fedasync import FedAsyncStrategy  # noqa: E402
from repro_torch.sim import reference  # noqa: E402
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.state_pool import HostStatePool  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

ATOL, RTOL = 3e-4, 3e-3
NAME, HIDDEN, K, N_PER = "lstm_regression", 12, 6, 60
POOL_STATS = ("state_dtype", "state_residency", "stacked_state_bytes",
              "host_pool_bytes", "gathered_rows", "scattered_rows")


def _raised(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


# ---------------------------------------------------------------------------
# HostStatePool against the JAX package's
# ---------------------------------------------------------------------------


def _pool_pair(shards, packed, bf16, n_rows=17):
    """(port pool, JAX pool, port block, JAX block): the same template
    and initial block; the bf16 leaf is int16 patterns in the port's,
    ml_dtypes bf16 in JAX's."""
    rng = np.random.default_rng(11)
    block = {"a": rng.normal(size=(n_rows, 2, 3)).astype(np.float32),
             "q": rng.integers(-7, 8, (n_rows, 5)).astype(np.int8)}
    jblock = dict(block)
    if bf16:
        jb = np.asarray(jnp.asarray(rng.normal(size=(n_rows, 4)),
                                    jnp.bfloat16))
        jblock["b"] = jb
        block["b"] = jb.view(np.int16)
    pool = HostStatePool({k: v[0] for k, v in block.items()}, n_rows,
                         packed=packed, shards=shards)
    jpool = jax_pool.HostStatePool({k: v[0] for k, v in jblock.items()},
                                   n_rows, packed=packed, shards=shards)
    return pool, jpool, block, jblock


def _same_storage(pool, jpool):
    items, jitems = pool.flat_items(), jpool.flat_items()
    assert [k for k, _ in items] == [k for k, _ in jitems]
    for (_, a), (_, b) in zip(items, jitems):
        if b.dtype.name == "bfloat16":
            b = b.view(np.int16)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert pool.nbytes == jpool.nbytes


def _same_block(got, jgot):
    for k in jgot:
        j = jgot[k]
        np.testing.assert_array_equal(
            got[k], j.view(np.int16) if j.dtype.name == "bfloat16" else j)


@pytest.mark.parametrize("shards,packed,bf16", [
    (1, False, False), (3, False, False), (4, True, False), (3, True, True),
])
def test_pool_matches_jax_pool(shards, packed, bf16):
    pool, jpool, block, jblock = _pool_pair(shards, packed, bf16)
    for p, b in ((pool, block), (jpool, jblock)):
        p.write_block(0, b)
        p.write_block(9, {k: v[9:][::-1].copy() for k, v in b.items()})
    _same_storage(pool, jpool)  # the second write reversed rows 9..16
    rows = np.array([0, 5, 16, 2, 9])
    got, seq = pool.gather(rows)
    jgot, jseq = jpool.gather(rows)
    assert seq == jseq
    _same_block(got, jgot)
    # a speculative gather, rolled back: data and counters unchanged
    snap, jsnap = pool.counters(), jpool.counters()
    pool.gather(np.array([1, 3, 4]))
    jpool.gather(np.array([1, 3, 4]))
    pool.restore_counters(snap)
    jpool.restore_counters(jsnap)
    assert pool.counters() == snap and pool.gathered_rows == 5
    # a later scatter (the previous window committing) dirties rows 5
    # and 2; patch re-copies exactly those
    rng = np.random.default_rng(13)
    upd = {"a": rng.normal(size=(4, 2, 3)).astype(np.float32),
           "q": rng.integers(-7, 8, (4, 5)).astype(np.int8)}
    jupd = dict(upd)
    if bf16:
        jupd["b"] = np.asarray(jnp.asarray(rng.normal(size=(4, 4)),
                                           jnp.bfloat16))
        upd["b"] = jupd["b"].view(np.int16)
    pool.scatter(np.array([5, 2]), upd)
    jpool.scatter(np.array([5, 2]), jupd)
    assert pool.patch(got, rows, seq) == jpool.patch(jgot, rows, jseq) == 2
    _same_block(got, jgot)
    _same_block({k: v[[1, 3]] for k, v in got.items()},
                {k: v[:2] for k, v in jupd.items()})
    _same_storage(pool, jpool)
    assert (pool.gathered_rows, pool.scattered_rows) == \
        (jpool.gathered_rows, jpool.scattered_rows) == (5, 2)
    assert pool.patch(got, rows, pool._seq) == 0  # nothing newer


@pytest.mark.parametrize("make", [
    lambda P: P({"a": np.zeros((3,), np.float32)}, 0),
    lambda P: P({"a": np.zeros((3,), np.float32)}, 4, shards=5),
    lambda P: P({"a": np.zeros((3,), np.float32)}, 4).load_flat({}),
    lambda P: P({"a": np.zeros((3,), np.float32)}, 4).load_flat(
        {"leaf0000_shard0000": np.zeros((4, 2), np.float32)}),
], ids=["n_rows", "shards", "missing", "mismatch"])
def test_pool_validation_matches_jax(make):
    assert _raised(lambda: make(HostStatePool)) == \
        _raised(lambda: make(jax_pool.HostStatePool))


# ---------------------------------------------------------------------------
# The engine and the oracles
# ---------------------------------------------------------------------------


def _cfg(wl, **kw):
    kw.setdefault("window", 4)
    return wl.run_config(T=32, batch_size=8, local_epochs=2, eta=0.02,
                         lam=1.0, beta=0.001, eval_every=16, seed=0, **kw)


@functools.lru_cache(maxsize=None)
def _w0():
    _, model = jax_get_workload(NAME).build(hidden=HIDDEN)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _port(alg, prefetch=None, **kw):
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=HIDDEN)
    trace, stats = [], {}
    hist = run_strategy(get_strategy(alg), model, cfg_model,
                        wl.make_clients(K, n_per=N_PER, seed=0),
                        _cfg(wl, **kw), device="cpu", init_params=_w0(),
                        trace=trace, stats=stats, prefetch=prefetch)
    return trace, stats, hist


@functools.lru_cache(maxsize=None)
def _jax(alg, state_dtype):
    """The JAX engine under host residency (2 pool shards): its trace
    and stats.  (The JAX package pins host == device bitwise itself.)"""
    wl = jax_get_workload(NAME)
    cfg_model, model = wl.build(hidden=HIDDEN)
    trace, stats = [], {}
    jax_run_strategy(jax_get_strategy(alg), model, cfg_model,
                     wl.make_clients(K, n_per=N_PER, seed=0),
                     _cfg(wl, state_dtype=state_dtype,
                          state_residency="host", state_shards=2),
                     trace=trace, stats=stats)
    return trace, stats


def _bitwise(tr_a, tr_b):
    assert len(tr_a) == len(tr_b) >= 2
    for (t1, w1), (t2, w2) in zip(tr_a, tr_b):
        assert t1 == t2 and set(w1) == set(w2)
        for k in w1:
            assert np.all(np.isfinite(w1[k])), f"{k} t={t1}"
            np.testing.assert_array_equal(w1[k], w2[k], err_msg=f"{k} t={t1}")


def _close(trace, ref, tag):
    ref = dict(ref)
    common = [t for t, _ in trace if t in ref]
    assert len(common) >= 2 and common[-1] == trace[-1][0], tag
    for t, w in trace:
        if t in ref:
            for k in w:
                np.testing.assert_allclose(
                    w[k], np.asarray(ref[t][k]), atol=ATOL, rtol=RTOL,
                    err_msg=f"{tag} {k} at t={t}")


@pytest.mark.parametrize("alg,state_dtype,window,prefetch,fold_mode", [
    ("asofed", None, 1, False, "sequential"),
    ("asofed", None, 1, True, "sequential"),
    ("asofed", None, 32, False, "sequential"),
    ("asofed", None, 32, True, "sequential"),
    ("asofed", "bf16", 32, False, "sequential"),
    ("asofed", "int8", 4, True, "sequential"),
    ("asofed", "int4", 32, False, "sequential"),
    ("fedasync", None, 4, False, "sequential"),
    ("fedbuff", None, 4, False, "sequential"),
    ("fedasync", "int8", 32, False, "associative"),
    ("fedbuff", "fp16", 4, True, "associative"),
])
def test_host_matches_device_bitwise(alg, state_dtype, window, prefetch,
                                     fold_mode):
    kw = dict(state_dtype=state_dtype, window=window, fold_mode=fold_mode,
              buffer_size=3)
    tr_d, st_d, hist_d = _port(alg, prefetch, **kw)
    tr_h, st_h, hist_h = _port(alg, prefetch, state_residency="host",
                               state_shards=3, **kw)
    _bitwise(tr_d, tr_h)
    assert [h.metrics for h in hist_d] == [h.metrics for h in hist_h]
    assert st_h["state_residency"] == "host"
    assert st_d["state_residency"] == "device"
    assert st_h["iters"] == st_d["iters"] == 32
    if window == 32:
        # windows of up to 32 arrivals from 6 clients: a client arriving
        # twice in a window shares its block row (lidx), while the server
        # reads its client id (idx)
        assert st_h["scattered_rows"] < st_h["iters"]
        assert st_h["gathered_rows"] > st_h["scattered_rows"]


@pytest.mark.parametrize("residency", ["device", "host"])
@pytest.mark.parametrize("state_dtype", ["bf16", "fp16", "int8", "int4"])
def test_asofed_codecs_match_jax_engine(state_dtype, residency):
    trace, stats, _ = _port("asofed", state_dtype=state_dtype,
                            state_residency=residency)
    jtrace, jstats = _jax("asofed", state_dtype)
    assert [t for t, _ in trace] == [t for t, _ in jtrace]
    _close(trace, jtrace, f"jax engine {state_dtype}")
    assert stats["state_dtype"] == jstats["state_dtype"] == state_dtype
    if residency == "host":
        for key in POOL_STATS:
            assert stats[key] == jstats[key], key
        assert stats["gather_s"] > 0.0 and stats["scatter_s"] > 0.0
    else:
        assert stats["host_pool_bytes"] == stats["gathered_rows"] == 0


@pytest.mark.parametrize("alg", ["asofed", "fedasync", "fedbuff"])
def test_oracles_int8_match_jax_and_host_engine(alg):
    wl, jwl = get_workload(NAME), jax_get_workload(NAME)
    cfg_model, model = wl.build(hidden=HIDDEN)
    jcm, jmodel = jwl.build(hidden=HIDDEN)
    kw = dict(state_dtype="int8", buffer_size=3)
    fn = f"run_{alg}_reference"
    ref = getattr(reference, fn)(
        model, cfg_model, wl.make_clients(K, n_per=N_PER, seed=0),
        _cfg(wl, **kw), device="cpu", init_params=_w0())
    jref = getattr(jax_reference, fn)(
        jmodel, jcm, jwl.make_clients(K, n_per=N_PER, seed=0),
        _cfg(jwl, **kw))
    assert sorted(ref) == sorted(jref) and len(ref) == 32
    _close(sorted(ref.items()), jref, f"jax {alg} oracle")
    trace, stats, _ = _port(alg, state_residency="host", **kw)
    _close(trace, ref, f"port {alg} host engine vs oracle")


def test_stats_keys_match_jax():
    _, stats, _ = _port("asofed", state_dtype="int4",
                        state_residency="host", state_shards=2)
    _, jstats = _jax("asofed", "int4")
    assert set(POOL_STATS + ("gather_s", "scatter_s")) <= set(stats)
    # the nibble-packed int4 pool holds the fleet in ~1/8 of the device
    # run's fp32 stack
    _, dstats, _ = _port("asofed")
    assert stats["host_pool_bytes"] < dstats["stacked_state_bytes"] / 4
    assert dstats["state_dtype"] == "fp32"
    assert (dstats["host_pool_bytes"], dstats["gathered_rows"],
            dstats["scattered_rows"], dstats["gather_s"],
            dstats["scatter_s"]) == (0, 0, 0, 0.0, 0.0)
    # a strategy without a codec stores fp32 whatever was asked
    _, fstats, _ = _port("fedavg", state_dtype="int8", participation=0.6)
    assert fstats["state_dtype"] == "fp32"
    assert jstats["host_pool_bytes"] == stats["host_pool_bytes"]


class _NoBatchedInit(FedAsyncStrategy):
    def build_init_client(self, model, cfg):
        return None


class _JaxNoBatchedInit(JaxFedAsync):
    def build_init_client(self, model, cfg):
        return None


@pytest.mark.parametrize("alg,cfg_kw", [
    ("fedavg", dict(state_residency="host")),
    ("local", dict(state_residency="host")),
    ("asofed", dict(state_residency="disk")),
    ("asofed", dict(state_shards=0)),
    ("no_batched_init", dict(state_residency="host")),
])
def test_refusals_match_jax(alg, cfg_kw):
    wl, jwl = get_workload(NAME), jax_get_workload(NAME)
    cm, model = wl.build(hidden=4)
    jcm, jmodel = jwl.build(hidden=4)
    if alg == "no_batched_init":
        strat, jstrat = _NoBatchedInit(), _JaxNoBatchedInit()
    else:
        strat, jstrat = get_strategy(alg), jax_get_strategy(alg)
    want = _raised(lambda: jax_run_strategy(
        jstrat, jmodel, jcm, jwl.make_clients(3, n_per=20, seed=0),
        jwl.run_config(T=4, **cfg_kw)))
    got = _raised(lambda: run_strategy(
        strat, model, cm, wl.make_clients(3, n_per=20, seed=0),
        wl.run_config(T=4, **cfg_kw), device="cpu"))
    assert got == want
