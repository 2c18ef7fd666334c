"""The port's upload codecs (``repro_torch.core.algorithms.common.
UploadCodec``) against the JAX package's, alone and in the engine.

Alone: each codec's ``encode`` over a cohort of deltas against the JAX
codec vmapped over the same deltas and slot keys, bit for bit (top-k on
tie-free data), the wire-byte accounting and the validation messages,
and the wire corruption against ``corrupt_wire_delta``.  In the engine:
asofed, fedasync, fedbuff and fedavg under each codec on a metered fleet
(the codec's bytes feed the arrival times), held against the JAX engine
and the port's own oracle at the engine-vs-oracle tolerance of
``tests/test_sim_engine.py``, with equal byte accounting.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.algorithms import common as jax_common  # noqa: E402
from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim.engine import run_strategy as jax_run_strategy  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core.algorithms import common  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.sim import reference  # noqa: E402
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

# the engine-vs-oracle tolerance of tests/test_sim_engine.py
ATOL, RTOL = 3e-4, 3e-3
NAME = "lstm_regression"
CODECS = ["identity", "topk_sparse", "random_mask", "quantized_delta"]
# strategy -> (config overrides, T): sync strategies count rounds
ALGS = {"asofed": ({}, 16), "fedasync": ({}, 16),
        "fedbuff": ({"buffer_size": 3}, 16),
        "fedavg": ({"participation": 0.6}, 6)}
# a paper-LSTM-shaped cohort of wire deltas (hidden 12)
SHAPES = {"b": (48,), "fc_b": (1,), "fc_w": (12, 1), "w_h": (12, 48),
          "w_x": (8, 48)}


def _deltas(P=5, seed=0):
    rng = np.random.default_rng(seed)
    d = {k: (1e-2 * rng.standard_normal((P,) + s)).astype(np.float32)
         for k, s in SHAPES.items()}
    t = rng.integers(0, 500, P).astype(np.float32)
    cid = rng.permutation(64)[:P].astype(np.int32)
    return d, t, cid


def _bitwise(got, want, tag):
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, (tag, k)
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{tag} {k}")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("frac,bits", [(0.1, 8), (0.4, 4), (1.0, 16)])
def test_encode_matches_jax_bitwise(codec, frac, bits):
    d, t, cid = _deltas()
    jcod = jax_common.UploadCodec(name=codec, frac=frac, bits=bits)

    def one(dd, ti, ci):  # the JAX tick's key for a slot
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), ti.astype(jnp.int32)), ci)
        return jcod.encode(dd, key)

    want = jax.jit(jax.vmap(one))({k: jnp.asarray(v) for k, v in d.items()},
                                  jnp.asarray(t), jnp.asarray(cid))
    cod = common.UploadCodec(name=codec, frac=frac, bits=bits)
    keys = common.upload_keys(prng.prng_key(0), torch.tensor(t),
                              torch.tensor(cid))
    _bitwise(cod.encode({k: torch.tensor(v) for k, v in d.items()}, keys),
             want, codec)


@pytest.mark.parametrize("codec", CODECS)
def test_wire_bytes_match_jax(codec):
    for frac, bits in [(0.1, 8), (0.37, 3), (1.0, 16)]:
        jcod = jax_common.UploadCodec(name=codec, frac=frac, bits=bits)
        cod = common.UploadCodec(name=codec, frac=frac, bits=bits)
        for size in (1, 7, 256, 16384):
            for itemsize in (2, 4):
                assert cod.leaf_bytes(size, itemsize) == \
                    jcod.leaf_bytes(size, itemsize)
        d, _, _ = _deltas(P=1)
        assert cod.tree_bytes({k: torch.tensor(v[0]) for k, v in d.items()}) \
            == jcod.tree_bytes({k: jnp.asarray(v[0]) for k, v in d.items()})


@pytest.mark.parametrize("kw", [dict(upload_codec="lz4"),
                                dict(upload_codec="topk_sparse",
                                     upload_frac=0.0),
                                dict(upload_codec="random_mask",
                                     upload_frac=1.5),
                                dict(upload_codec="quantized_delta",
                                     upload_bits=1),
                                dict(upload_codec="quantized_delta",
                                     upload_bits=17)])
def test_resolve_errors_match_jax(kw):
    from repro.sim.engine import RunConfig as JaxRunConfig
    from repro_torch.sim.engine import RunConfig

    with pytest.raises(ValueError) as jerr:
        jax_common.resolve_upload_codec(JaxRunConfig(**kw))
    with pytest.raises(ValueError) as err:
        common.resolve_upload_codec(RunConfig(**kw))
    assert str(err.value) == str(jerr.value)


def test_corruption_matches_jax():
    """Codes 0 (clean), 1 (NaN), 2 (Inf) bit for bit; code 3's gaussian
    noise through torch's erfinv within 1e-5 relative of its size."""
    d, t, cid = _deltas(P=6, seed=3)
    codes = np.array([0, 1, 2, 3, 3, 0], np.int32)
    want = jax.jit(jax.vmap(lambda dd, c, ti, ci: jax_common.
                            corrupt_wire_delta(dd, c, jax_common.
                                               corruption_key(0, ti, ci))))(
        {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(codes),
        jnp.asarray(t), jnp.asarray(cid))
    got = common.corrupt_wire_delta(
        {k: torch.tensor(v) for k, v in d.items()}, torch.tensor(codes),
        common.corruption_key(prng.prng_key(0), torch.tensor(t),
                              torch.tensor(cid)))
    clean = codes != 3
    for k in d:
        a, b = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(a[clean].view(np.int32),
                                      b[clean].view(np.int32), err_msg=k)
        noise = b[~clean] - d[k][~clean]
        np.testing.assert_allclose(a[~clean] - d[k][~clean], noise,
                                   rtol=1e-5, atol=1e-5 * np.abs(noise).max(),
                                   err_msg=k)


def _cfg(wl, alg, codec):
    over, T = ALGS[alg]
    return wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                         lam=1.0, beta=0.001, eval_every=T // 2, seed=0,
                         upload_codec=codec, upload_frac=0.4, **over)


def _clients(wl):  # a metered fleet: the codec's bytes feed the delays
    return wl.make_clients(4, n_per=40, seed=0,
                           bandwidth_range=(2000.0, 20000.0))


@functools.lru_cache(maxsize=None)
def _jax(alg, codec):
    """(w0, trace, stats) of the JAX engine."""
    wl = jax_get_workload(NAME)
    cfg_model, model = wl.build(hidden=8)
    cfg = _cfg(wl, alg, codec)
    w0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(cfg.seed)))
    trace, stats = [], {}
    jax_run_strategy(jax_get_strategy(alg), model, cfg_model, _clients(wl),
                     cfg, trace=trace, stats=stats)
    return w0, trace, stats


def _close(trace, ref, tag):
    ref = dict(ref)
    assert trace and trace[-1][0] in ref, tag
    for t, w in trace:
        assert t in ref, f"{tag}: boundary t={t} not in the reference"
        for k in w:
            np.testing.assert_allclose(w[k], np.asarray(ref[t][k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{tag} {k} at t={t}")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_engine_matches_jax_engine_and_oracle(alg, codec):
    w0, jtrace, jstats = _jax(alg, codec)
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=8)
    cfg = _cfg(wl, alg, codec)
    trace, stats = [], {}
    run_strategy(get_strategy(alg), model, cfg_model, _clients(wl), cfg,
                 device="cpu", init_params=w0, trace=trace, stats=stats)
    assert [t for t, _ in trace] == [t for t, _ in jtrace]
    _close(trace, jtrace, "jax engine")
    ostats = {}
    oracle = getattr(reference, f"run_{alg}_reference")
    traj = oracle(model, cfg_model, _clients(wl), cfg, stats=ostats,
                  device="cpu", init_params=w0)
    _close(trace, traj, "oracle")
    # byte accounting: the metered delays saw the same bytes
    for key in ("upload_codec", "upload_bytes", "upload_bytes_total"):
        assert stats[key] == jstats[key], key
    assert ostats["upload_codec"] == codec
    assert ostats["upload_bytes"] == stats["upload_bytes"] > 0.0
    if codec != "identity":
        dense = common.UploadCodec().tree_bytes(
            {k: torch.tensor(v) for k, v in w0.items()})
        assert stats["upload_bytes"] < dense


@pytest.mark.parametrize("alg", ["local", "global"])
def test_codec_without_upload_view_fails_fast(alg):
    wl = get_workload(NAME)
    cfg_model, model = wl.build(hidden=8)
    cfg = wl.run_config(T=4, batch_size=8, local_epochs=1, eval_every=2,
                        upload_codec="topk_sparse")
    with pytest.raises(ValueError, match="upload_codec_view"):
        run_strategy(get_strategy(alg), model, cfg_model,
                     wl.make_clients(3, n_per=40, seed=0), cfg,
                     device="cpu")
