"""The port's fused ASO-Fed tick fold (``feature_fold``) against the JAX
package's sequential fold and against the port's former per-arrival loop.

On the CPU the dispatcher runs the plain version, ``feature_fold_ref``:
it is held within the engine's tolerance of a ``jax.lax.scan`` of the
JAX package's ``AsoFedStrategy.build_fold`` (the feature pass through the
Pallas kernel in interpret mode and through jnp), and bit for bit to the
loop the engine ran before the fold was fused.  The CUDA kernel itself
is checked on the card (``cuda`` marker; skipped where there is none).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.pytree import tree_where as jax_tree_where  # noqa: E402
from repro.core.algorithms.asofed import (  # noqa: E402
    AsoFedStrategy as JaxAsoFed)
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.core.algorithms.asofed import AsoFedStrategy  # noqa: E402
from repro_torch.core.feature_learning import first_layer_path  # noqa: E402
from repro_torch.kernels.feature_attention.kernel import (  # noqa: E402
    FOLD_MAX_LEAVES, feature_fold_kernel)
from repro_torch.kernels.feature_attention.ops import (  # noqa: E402
    feature_fold)
from repro_torch.kernels.feature_attention.ref import (  # noqa: E402
    feature_fold_ref)
from repro_torch.sim.engine import run_strategy  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

# the engine-vs-oracle tolerance of tests/test_sim_engine.py: the two
# frameworks sum the feature pass's row reductions in different orders
ATOL, RTOL = 3e-4, 3e-3
WORKLOADS = ["lstm_regression", "cnn_classification", "lstm_multilabel"]
# (S, n_real, a client twice): padding, a repeated client, one arrival,
# a full bucket
CASES = {"padded": (8, 6, False), "repeat": (8, 5, True),
         "one": (4, 1, False), "full": (8, 8, False)}
CLIENTS = 10  # counts n'_k: one slot per client and a scratch slot


def _tick(shapes, S, n_real, repeat, seed=0, clients=CLIENTS):
    """Numpy inputs of one tick: server leaves (a model's scale), uploads
    at the scale of real deltas, whole-number counts, the slots' clients
    (padded slots on the scratch row) and their new counts."""
    rng = np.random.default_rng(seed)
    w = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    d = {k: (1e-2 * rng.standard_normal((S,) + s)).astype(np.float32)
         for k, s in shapes.items()}
    n = np.zeros(clients + 1, np.float32)
    n[:clients] = rng.integers(1, 40, clients)
    idx = np.full(S, clients, np.int64)
    idx[:n_real] = rng.permutation(clients)[:n_real]
    if repeat:
        idx[n_real - 1] = idx[0]
    n_vis = n[idx] + rng.integers(0, 6, S).astype(np.float32)
    n_vis[n_real:] = 0.0
    return w, d, n, idx, n_vis


def _shapes(name):
    cfg_model, model = get_workload(name).build(hidden=12)
    return cfg_model, model, {k: tuple(v.shape) for k, v in
                              model.init(torch.Generator().manual_seed(0),
                                         device="cpu").items()}


def _torch(w, d, n, idx, n_vis):
    t = torch.tensor
    return ({k: t(v) for k, v in w.items()}, {k: t(v) for k, v in d.items()},
            t(n), t(idx), t(n_vis))


def _old_loop(model, cfg_model, cfg, w, d, n, idx, n_vis, n_real):
    """The engine's sequential fold before it was fused: the strategy's
    per-arrival fold in a Python loop, padded slots a copy of the last
    real one (``repro_torch.sim.compile.tick_body``'s loop)."""
    fold = AsoFedStrategy().build_fold(model, cfg_model, cfg)
    server, received = {"w": w, "n": n}, []
    t_arr = torch.zeros(idx.shape[0])
    for s in range(n_real):
        server, rec = fold(server, tree_map(lambda u: u[s], d), idx[s],
                           n_vis[s], t_arr[s])
        received.append(rec)
    pad = (received[-1],) * (idx.shape[0] - n_real)
    return server["w"], server["n"], tree_map(
        lambda *rs: torch.stack(rs), *received, *pad)


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_bitwise_equals_former_loop(name, case):
    S, n_real, repeat = CASES[case]
    cfg_model, model, shapes = _shapes(name)
    args = _torch(*_tick(shapes, S, n_real, repeat))
    cfg = get_workload(name).run_config()
    want = _old_loop(model, cfg_model, cfg, *args, n_real)
    got = feature_fold(*args[:1], args[1], first_layer_path(cfg_model)[0],
                       *args[2:], n_real)
    assert torch.equal(got[1], want[1])
    for part in (0, 2):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)
    # padded slots: a copy of the last real one
    for k, r in got[2].items():
        assert r.shape == (S,) + shapes[k]
        for s in range(n_real, S):
            assert torch.equal(r[s], r[n_real - 1])


def _jax_scan(name, w, d, n, idx, n_vis, n_real, use_kernel):
    jwl = jax_get_workload(name)
    cfg_model, jmodel = jwl.build(hidden=12)
    cfg = jwl.run_config(feature_kernel=use_kernel,
                         feature_kernel_interpret=use_kernel)
    fold = JaxAsoFed().build_fold(jmodel, cfg_model, cfg)
    S = idx.shape[0]
    mask = jnp.arange(S) < n_real

    def step(sv, inp):
        up, ix, nv, ta, mk = inp
        sv2, rec = fold(sv, up, ix, nv, ta)
        return jax_tree_where(mk, sv2, sv), rec

    server, received = jax.jit(lambda sv, xs: jax.lax.scan(step, sv, xs))(
        {"w": {k: jnp.asarray(v) for k, v in w.items()},
         "n": jnp.asarray(n)},
        ({k: jnp.asarray(v) for k, v in d.items()},
         jnp.asarray(idx.astype(np.int32)), jnp.asarray(n_vis),
         jnp.zeros(S, jnp.float32), mask))
    return jax.tree.map(np.asarray, (server["w"], server["n"], received))


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("lowering", ["pallas_interpret", "jnp"])
def test_ref_matches_jax_sequential_scan(name, case, lowering):
    S, n_real, repeat = CASES[case]
    cfg_model, _, shapes = _shapes(name)
    inputs = _tick(shapes, S, n_real, repeat, seed=1)
    w_j, n_j, rec_j = _jax_scan(name, *inputs, n_real,
                                lowering == "pallas_interpret")
    w_t, n_t, rec_t = feature_fold_ref(
        *_torch(*inputs)[:2], first_layer_path(cfg_model)[0],
        *_torch(*inputs)[2:], n_real)
    np.testing.assert_array_equal(n_t.numpy(), n_j)
    for k in shapes:
        np.testing.assert_allclose(w_t[k].numpy(), w_j[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
        # the real slots' downloads (the JAX scan's padded slots hold the
        # fold of a masked slot; the engine reverts either at its scatter)
        np.testing.assert_allclose(rec_t[k][:n_real].numpy(),
                                   rec_j[k][:n_real], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_engine_folds_a_tick_in_one_call(monkeypatch):
    """The CPU engine runs asofed's sequential fold through the fused
    tick fold, once per tick with a fold; ASO-Fed(-F) keeps the loop."""
    from repro_torch.core.algorithms import asofed

    calls = []

    def counting(*args, **kw):
        calls.append(args[6])  # n_real
        return feature_fold(*args, **kw)

    monkeypatch.setattr(asofed, "feature_fold", counting)
    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=12)
    for feature_learning in (True, False):
        calls.clear()
        stats = {}
        run_strategy(get_strategy("asofed"), model, cfg_model,
                     wl.make_clients(5, n_per=60, seed=0),
                     wl.run_config(T=20, batch_size=8, eval_every=0,
                                   feature_learning=feature_learning),
                     device="cpu", stats=stats)
        if feature_learning:
            assert len(calls) == stats["ticks"] and sum(calls) == 20
        else:
            assert calls == []


def _small_args():
    w, d, n, idx, n_vis = _tick({"w_x": (4, 16), "b": (16,)}, 4, 3, False)
    return _torch(w, d, n, idx, n_vis)


def test_kernel_forced_on_cpu_raises():
    w, d, n, idx, n_vis = _small_args()
    with pytest.raises(ValueError, match="feature_kernel=True"):
        feature_fold(w, d, "w_x", n, idx, n_vis, 3, use_kernel=True)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_cpu_tensors_take_plain_version(use_kernel):
    w, d, n, idx, n_vis = _small_args()
    got = feature_fold(w, d, "w_x", n, idx, n_vis, 3, use_kernel=use_kernel)
    want = feature_fold_ref(w, d, "w_x", n, idx, n_vis, 3)
    assert torch.equal(got[1], want[1])
    assert all(torch.equal(got[0][k], want[0][k]) for k in w)


def test_non_fp32_state_raises():
    w, d, n, idx, n_vis = _small_args()
    w = {k: v.to(torch.bfloat16) for k, v in w.items()}
    with pytest.raises(ValueError, match="fp32"):
        feature_fold(w, d, "w_x", n, idx, n_vis, 3)


@pytest.mark.parametrize("n_real", [0, 5])
def test_n_real_outside_the_bucket_raises(n_real):
    w, d, n, idx, n_vis = _small_args()  # S = 4
    with pytest.raises(ValueError, match="real slots"):
        feature_fold(w, d, "w_x", n, idx, n_vis, n_real)


def test_kernel_wrapper_refuses_cpu_tensors():
    w, d, n, idx, n_vis = _small_args()
    before = feature_fold_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        feature_fold_kernel([w["w_x"], w["b"]], [d["w_x"], d["b"]], 0, 4,
                            16, n, idx, n_vis, 3)
    assert feature_fold_kernel.launches == before


def test_kernel_wrapper_refuses_too_many_leaves():
    w, d, n, idx, n_vis = _small_args()
    L = FOLD_MAX_LEAVES + 1
    with pytest.raises(ValueError, match=f"1 to {FOLD_MAX_LEAVES} leaves"):
        feature_fold_kernel([w["b"]] * L, [d["b"]] * L, 0, 1, 16, n, idx,
                            n_vis, 3)


# on the card: (leaf shapes, first layer, S, n_real, repeat)
LSTM64 = {"w_x": (8, 256), "w_h": (64, 256), "b": (256,), "fc_w": (64, 1),
          "fc_b": (1,)}
CUDA_CASES = {
    "main_tick": (LSTM64, "w_x", 64, 51, False),
    "one": (LSTM64, "w_x", 64, 1, False),
    "full": (LSTM64, "w_x", 64, 64, False),
    "repeat": (LSTM64, "w_x", 64, 51, True),
    "cnn12": ({"conv1_w": (3, 3, 1, 12), "conv1_b": (12,),
               "fc_w": (2352, 10), "fc_b": (10,)}, "conv1_w", 16, 13, False),
    "multilabel": ({"w_x": (32, 256), "w_h": (64, 256), "b": (256,),
                    "fc_w": (64, 6), "fc_b": (6,)}, "w_x", 32, 20, False),
    "wide": ({"w_x": (4, 1500), "b": (1500,)}, "w_x", 16, 11, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes, first, S, n_real, repeat = CUDA_CASES[case]
    args = [tree_map(lambda t: t.cuda(), a)
            for a in _torch(*_tick(shapes, S, n_real, repeat,
                                   clients=256))]
    before = feature_fold_kernel.launches
    got = feature_fold(args[0], args[1], first, *args[2:], n_real)
    torch.cuda.synchronize()
    assert feature_fold_kernel.launches == before + 1
    want = feature_fold_ref(args[0], args[1], first, *args[2:], n_real)
    assert torch.equal(got[1], want[1])
    for part in (0, 2):
        for k in shapes:
            if k != first:
                assert torch.equal(got[part][k], want[part][k]), (part, k)
                continue
            # the feature pass sums each row in another order: a few ulps
            # an arrival, carried into the later arrivals
            err = float((got[part][k] - want[part][k]).abs().max())
            scale = max(1.0, float(want[part][k].abs().max()))
            assert err <= n_real * 1e-6 * scale, (part, err)


# ---------------------------------------------------------------------------
# reps: the chaos layer's per-slot fold count (0 rejected, 1, 2 duplicated)
# ---------------------------------------------------------------------------

REPS_PATTERNS = ["mixed", "skip_all", "dup_all"]


def _reps(pattern, S, n_real, seed=0):
    """(S,) int32 fold counts: the real slots' from a seeded draw over
    {0, 1, 2} (mixed), all 0 or all 2; padded slots 0, as the engine's
    ``admit * (1 + dup)`` gives them."""
    reps = np.zeros(S, np.int32)
    if pattern == "mixed":
        reps[:n_real] = np.random.default_rng(seed).integers(0, 3, n_real)
    else:
        reps[:n_real] = 0 if pattern == "skip_all" else 2
    return reps


def _jax_scan_reps(name, w, d, n, idx, n_vis, reps, use_kernel):
    """The JAX tick's sequential fold under the chaos layer
    (``repro.sim.compile``: a second fold under ``mk & dp``, the server
    untouched where ``mk`` is False), ``mk = reps > 0``, ``dp = reps ==
    2``."""
    jwl = jax_get_workload(name)
    cfg_model, jmodel = jwl.build(hidden=12)
    cfg = jwl.run_config(feature_kernel=use_kernel,
                         feature_kernel_interpret=use_kernel)
    fold = JaxAsoFed().build_fold(jmodel, cfg_model, cfg)
    S = idx.shape[0]

    def step(sv, inp):
        up, ix, nv, ta, mk, dp = inp
        sv2, rec = fold(sv, up, ix, nv, ta)
        sv3, rec2 = fold(sv2, up, ix, nv, ta)
        sv2 = jax_tree_where(mk & dp, sv3, sv2)
        rec = jax_tree_where(mk & dp, rec2, rec)
        return jax_tree_where(mk, sv2, sv), rec

    server, received = jax.jit(lambda sv, xs: jax.lax.scan(step, sv, xs))(
        {"w": {k: jnp.asarray(v) for k, v in w.items()},
         "n": jnp.asarray(n)},
        ({k: jnp.asarray(v) for k, v in d.items()},
         jnp.asarray(idx.astype(np.int32)), jnp.asarray(n_vis),
         jnp.zeros(S, jnp.float32), jnp.asarray(reps > 0),
         jnp.asarray(reps == 2)))
    return jax.tree.map(np.asarray, (server["w"], server["n"], received))


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("pattern", REPS_PATTERNS)
@pytest.mark.parametrize("lowering", ["pallas_interpret", "jnp"])
def test_ref_with_reps_matches_jax_sequential_scan(name, pattern, lowering):
    S, n_real, repeat = CASES["repeat"]  # a client twice in the tick
    cfg_model, _, shapes = _shapes(name)
    inputs = _tick(shapes, S, n_real, repeat, seed=2)
    reps = _reps(pattern, S, n_real, seed=3)
    w_j, n_j, rec_j = _jax_scan_reps(name, *inputs, reps,
                                     lowering == "pallas_interpret")
    w_t, n_t, rec_t = feature_fold(
        *_torch(*inputs)[:2], first_layer_path(cfg_model)[0],
        *_torch(*inputs)[2:], n_real, reps=torch.tensor(reps))
    np.testing.assert_array_equal(n_t.numpy(), n_j)
    for k in shapes:
        np.testing.assert_allclose(w_t[k].numpy(), w_j[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
        # the folded slots' downloads (a skipped slot's is any finite
        # copy: the engine's merge is masked by admission)
        fold = reps[:n_real] > 0
        np.testing.assert_allclose(rec_t[k][:n_real][fold].numpy(),
                                   rec_j[k][:n_real][fold], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
        assert np.all(np.isfinite(rec_t[k].numpy()))


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_reps_none_bitwise_equals_reps_all_ones(name, case):
    S, n_real, repeat = CASES[case]
    cfg_model, _, shapes = _shapes(name)
    args = _torch(*_tick(shapes, S, n_real, repeat, seed=4))
    (first,) = first_layer_path(cfg_model)
    want = feature_fold(args[0], args[1], first, *args[2:], n_real)
    got = feature_fold(args[0], args[1], first, *args[2:], n_real,
                       reps=torch.ones(S, dtype=torch.int32))
    assert torch.equal(got[1], want[1])
    for part in (0, 2):
        for k in shapes:
            assert torch.equal(got[part][k], want[part][k]), (part, k)


@pytest.mark.parametrize("reps,match", [
    (torch.ones(4, dtype=torch.int64), "int32"),
    (torch.ones(3, dtype=torch.int32), r"\(4,\) int32"),
    (torch.ones((4, 1), dtype=torch.int32), r"\(4,\) int32"),
])
def test_bad_reps_raise(reps, match):
    w, d, n, idx, n_vis = _small_args()  # S = 4
    with pytest.raises(ValueError, match=match):
        feature_fold(w, d, "w_x", n, idx, n_vis, 3, reps=reps)


def test_kernel_wrapper_refuses_bad_reps():
    w, d, n, idx, n_vis = _small_args()
    before = feature_fold_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        feature_fold_kernel([w["w_x"], w["b"]], [d["w_x"], d["b"]], 0, 4,
                            16, n, idx, n_vis, 3,
                            reps=torch.ones(4, dtype=torch.int32))
    assert feature_fold_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("pattern", REPS_PATTERNS)
def test_cuda_kernel_with_reps_matches_plain_version(case, pattern):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes, first, S, n_real, repeat = CUDA_CASES[case]
    args = [tree_map(lambda t: t.cuda(), a)
            for a in _torch(*_tick(shapes, S, n_real, repeat,
                                   clients=256))]
    reps = torch.tensor(_reps(pattern, S, n_real), device="cuda")
    before = feature_fold_kernel.launches
    got = feature_fold(args[0], args[1], first, *args[2:], n_real,
                       reps=reps)
    torch.cuda.synchronize()
    assert feature_fold_kernel.launches == before + 1
    want = feature_fold_ref(args[0], args[1], first, *args[2:], n_real,
                            reps=reps)
    assert torch.equal(got[1], want[1])
    folds = int(reps.sum())
    for part in (0, 2):
        for k in shapes:
            if k != first:
                assert torch.equal(got[part][k], want[part][k]), (part, k)
                continue
            err = float((got[part][k] - want[part][k]).abs().max())
            scale = max(1.0, float(want[part][k].abs().max()))
            assert err <= max(folds, 1) * 1e-6 * scale, (part, err)
