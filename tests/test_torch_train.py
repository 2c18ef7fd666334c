"""The port's training slice against the JAX package's.

Every check feeds both packages the same inputs: the JAX model's own
weights (``jax.tree.map(np.asarray, model.init(PRNGKey(s)))`` through
``params_from_numpy``), numpy draws, and token streams from each
package's copy of ``data/lm.py`` (bit for bit the same, see
``tests/test_torch_host.py``).  The JAX side runs its XLA attention
(``LOCAL``), what its training path takes; the port's loss takes
``blocked_attention`` under autograd.

Checked, with the tolerance stated at each:

* (a) ``Model.loss``, its ``ce`` / ``aux`` metrics and the gradient of
  every leaf, against ``jax.value_and_grad(model.loss)``, for every
  assigned architecture at ``reduced()`` size;
* (b) ``chunked_softmax_xent`` with and without a mask and with
  ``S % n_chunks != 0``, value and gradients;
* (c) ``asofed_transform`` over several rounds: the prox term on and off
  (``lam = 0``), ``dynamic_lr=False``, a zero-size inactive slot leaf,
  bf16 slots;
* (d) each optimizer of ``optim/optimizers.py`` step by step;
* (e) the port's training loop against the JAX training script's loop,
  written here from the JAX package's functions (reduced Qwen2-0.5B,
  Falcon-Mamba-7B, RecurrentGemma-9B, DeepSeek-V2-Lite and Kimi-K2, 3
  clients, 8 steps: every client holds a server snapshot that later
  folds must leave as it was; the RG-LRU layers' gradients go through
  ``LinearScan``, the Mamba layers' through ``SelectiveScan``);
* (f) the quickstart path's per-round losses and final prefill logits
  against the JAX example's loop;
* (g) ``--checkpoint`` written by the port, read by
  ``repro.checkpoint.load_checkpoint``;
* (h) the refusals: K3's and K2's wrappers under grad, then the SSM and
  hybrid gradients through ``SelectiveScan`` and ``LinearScan``,
  ``first_layer_path`` of every family and the feature pass on a tied
  embedding;
* ``chip_smoke.py``'s first-step gate, gradient gap, forced routing
  (``Routing``) and ``train_witness.py``'s fp64 gradient.

The card's cases (K1 once a fold, the SSM and hybrid gradients and the
dense loop on the card against the CPU) are in
``tests/test_torch_train_card.py``, which imports no JAX.
"""
import dataclasses
import heapq
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import feature_learning as jfl  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import asofed as jasofed  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.common.pytree import (  # noqa: E402
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.paper_models import (  # noqa: E402
    paper_cnn, paper_lstm)
from repro_torch.core import feature_learning as fl  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_kernel)
from repro_torch.launch import quickstart as qs  # noqa: E402
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import asofed, optimizers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (a) loss: |port - JAX| per unit of |JAX loss|; measured <= 3e-7 (fp32
# sums in another order).  Gradients: per leaf, max abs error per unit of
# the leaf's largest |JAX gradient|, floored at GRAD_FLOOR x the largest
# over all leaves (a leaf whose true gradient is 0 holds only rounding
# noise: the key biases, whose shift every softmax cancels).  Measured
# worst 4.3e-4 (Kimi-K2's layer-0 norm scale): the reduced models'
# random-init attention is near one-hot, and both packages' fp32 scores
# sit on its steep side.
LOSS_TOL = 1e-5
GRAD_TOL = 2e-3
GRAD_FLOOR = 1e-3
B, S = 2, 24
# Whisper's as-drawn attention is near one-hot (tests/test_torch_audio.py):
# every attention's wq and wk are scaled by COOL on both sides
COOL = 0.125
# MoE routing is compared only on draws whose k-th and (k+1)-th router
# probabilities are this far apart: a near tie flips between lax.top_k
# and the port's sort on rounding alone, and the loss is discontinuous
# there
MIN_ROUTE_GAP = 1e-4
# (b)-(d): fp32 elementwise and reduction order; per unit of the largest
# magnitude (at least 1)
FP32_TOL = 2e-6
# (c) bf16 slots: one bf16 ulp (2^-8) per unit, the rounding of a product
# computed in fp32 by one package and XLA's bf16 op by the other
BF16_TOL = 2 ** -8
# (e), (f): a whole federated run, 8 steps of 3 clients or 24 quickstart
# rounds, per unit of the largest JAX magnitude: each step's loss, each
# final server leaf, the final prefill logits.  Both sides' attention is
# cooled (COOL): as drawn, the reduced models' GQA scores reach ~60 (the
# JAX spec's fan_in of a (d, heads, hd) projection is its head count),
# and the JAX package's own jitted and eager loops part by 1.5e-3 in the
# loss within 8 steps, as much as the port and JAX do (1.7e-3).  Cooled,
# measured: losses 7.5e-8 (loop) and 1.4e-7 (quickstart), weights
# 2.4e-7, logits 2.7e-6.
RUN_TOL = 2e-5


def _rel(got, want) -> float:
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0)) / max(
        float(np.max(np.abs(want), initial=0.0)), 1.0)


def _cooled(w):
    """``w`` with every attention's wq and wk scaled by COOL."""
    if not isinstance(w, dict):
        return w
    return {k: (v * COOL if k in ("wq", "wk") and not isinstance(v, dict)
                else _cooled(v)) for k, v in w.items()}


def _pair(arch, seed=0, cool=None):
    """(JAX model, numpy weights, port model, port CPU weights) at
    ``reduced()`` size; with ``cool`` (default: Whisper only) every
    attention's wq and wk scaled by COOL."""
    jcfg = jax_get_arch(arch).reduced()
    jm = jax_build_model(jcfg, LOCAL)
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if jcfg.family == "audio" if cool is None else cool:
        w = _cooled(w)
    tm = build_model(get_arch(arch).reduced())
    return jm, w, tm, params_from_numpy(w, device="cpu")


def _port_grad(model, params, batch):
    """(loss, metrics, gradient tree) of the port's ``Model.loss``."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, met = model.loss(p, batch)
    g = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                            materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in met.items()},
            tree_unflatten(p, list(g)))


# ---------------------------------------------------------------------------
# (a) the loss and its gradients, every assigned architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_loss_and_gradients_match_jax(arch, monkeypatch):
    jm, w, tm, p = _pair(arch)
    b = make_batch(tm.cfg, B, S, seed=1, device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q, bb: jm.loss(q, bb), has_aux=True))(w, jb)

    gaps = []
    route = moe_lib._route

    def spy(router_w, xt, k):
        probs = torch.softmax((xt @ router_w).detach().float(), -1)
        top = torch.sort(probs, -1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return route(router_w, xt, k)

    monkeypatch.setattr(moe_lib, "_route", spy)
    loss, met, g = _port_grad(tm, p, b)
    if tm.cfg.family == "moe":
        assert gaps and min(gaps) > MIN_ROUTE_GAP, gaps
        assert float(jmet["aux"]) > 0.0
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    for name in ("ce", "aux"):
        assert abs(float(met[name]) - float(jmet[name])) <= LOSS_TOL * max(
            abs(float(jmet[name])), 1.0), name

    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = {"/".join(path): v for path, v in tree_flatten_with_path(g)}
    assert sorted(got) == sorted(want)
    floor = GRAD_FLOOR * max(float(np.max(np.abs(v))) for v in want.values())
    for name, wv in want.items():
        gv = got[name].numpy()
        assert gv.shape == wv.shape, name
        scale = max(float(np.max(np.abs(wv))), floor)
        err = float(np.max(np.abs(gv - wv))) / scale
        assert err <= GRAD_TOL, (name, err)


def test_logits_and_serve_paths_take_no_aux():
    """``forward_hidden`` returns (x, aux); ``logits_fn`` and the prefill
    still give the serve path's logits."""
    from repro_torch.models import transformer as tf

    _, _, tm, p = _pair("kimi-k2-1t-a32b")
    b = make_batch(tm.cfg, B, S, seed=1, device="cpu")
    with torch.no_grad():
        x, aux = tf.forward_hidden(p, tm.cfg, b)
        logits = tm.predict(p, b)
        last, _ = tm.prefill(p, {"tokens": b["tokens"]}, max_len=S + 1)
    assert aux.dtype == torch.float32 and float(aux) > 0.0
    assert torch.equal(logits, x @ p["lm_head"]["w"])
    assert _rel(last, logits[:, -1].numpy()) < 1e-5


# ---------------------------------------------------------------------------
# (b) the chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,masked", [(24, False), (24, True),
                                        (10, False), (10, True)])
def test_chunked_softmax_xent_matches_jax(seq, masked):
    """S = 24 runs 8 chunks of 3, S = 10 one chunk (10 % 8 != 0)."""
    rng = np.random.default_rng(seq + masked)
    x = rng.standard_normal((2, seq, 16), dtype=np.float32)
    head = rng.standard_normal((16, 40), dtype=np.float32)
    labels = rng.integers(0, 40, (2, seq)).astype(np.int32)
    mask = (rng.uniform(size=(2, seq)) < 0.6).astype(np.float32) \
        if masked else None

    def jloss(xx, hh):
        return jlayers.chunked_softmax_xent(
            xx, hh, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask))

    want, (gx_w, gh_w) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    xt = torch.tensor(x, requires_grad=True)
    ht = torch.tensor(head, requires_grad=True)
    got = layers.chunked_softmax_xent(
        xt, ht, torch.tensor(labels),
        mask=None if mask is None else torch.tensor(mask))
    gx, gh = torch.autograd.grad(got, (xt, ht))
    assert _rel(got, want) <= FP32_TOL
    assert _rel(gx, gx_w) <= FP32_TOL and _rel(gh, gh_w) <= FP32_TOL


# ---------------------------------------------------------------------------
# (c) the ASO-Fed transform
# ---------------------------------------------------------------------------

LEAVES = {"a": (6, 5), "b": (7,), "c": (3, 4)}


def _slots_pair(slot_dtype, inactive):
    """(JAX slots, port slots): zero fp32 slots cast to ``slot_dtype``;
    leaf ``c``'s slots zero-size when ``inactive``."""
    jd = jnp.bfloat16 if slot_dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if slot_dtype == "bf16" else torch.float32

    def jz(name):
        return jnp.zeros((0,) if inactive and name == "c"
                         else LEAVES[name], jd)

    def tz(name):
        return torch.zeros((0,) if inactive and name == "c"
                           else LEAVES[name], dtype=td)

    js = jasofed.AsoFedSlots(h={k: jz(k) for k in LEAVES},
                             v={k: jz(k) for k in LEAVES},
                             delay_sum=jnp.zeros((), jnp.float32),
                             rounds=jnp.zeros((), jnp.float32))
    ts = asofed.AsoFedSlots(h={k: tz(k) for k in LEAVES},
                            v={k: tz(k) for k in LEAVES},
                            delay_sum=torch.zeros(()),
                            rounds=torch.zeros(()))
    return js, ts


@pytest.mark.parametrize("lam,dynamic_lr,slot_dtype,inactive", [
    (0.1, True, "fp32", False), (0.0, True, "fp32", False),
    (0.1, False, "fp32", False), (0.1, True, "fp32", True),
    (0.1, True, "bf16", False), (0.1, True, "bf16", True)])
def test_asofed_transform_matches_jax(lam, dynamic_lr, slot_dtype, inactive):
    """Five rounds, each package carrying its own slots."""
    rng = np.random.default_rng(7)
    js, ts = _slots_pair(slot_dtype, inactive)
    tol = BF16_TOL if slot_dtype == "bf16" else FP32_TOL
    for rnd in range(5):
        draw = {k: {name: rng.standard_normal(s, dtype=np.float32)
                    for name, s in LEAVES.items()}
                for k in ("g", "w", "s")}
        delay = float(np.float32(rng.uniform(10, 100)))
        kw = dict(lam=lam, beta=0.001, eta=3e-3, delay=delay,
                  dynamic_lr=dynamic_lr)
        ju, js = jasofed.asofed_transform(
            jax.tree.map(jnp.asarray, draw["g"]), js,
            jax.tree.map(jnp.asarray, draw["w"]),
            jax.tree.map(jnp.asarray, draw["s"]), **kw)
        tu, ts = asofed.asofed_transform(
            tree_map(torch.tensor, draw["g"]), ts,
            tree_map(torch.tensor, draw["w"]),
            tree_map(torch.tensor, draw["s"]), **kw)
        for name in LEAVES:
            assert tu[name].dtype == {"bf16": torch.bfloat16}.get(
                slot_dtype if not (inactive and name == "c") else "",
                torch.float32), name
            assert _rel(tu[name], np.asarray(ju[name], np.float32)) <= tol, \
                (rnd, name)
            for slot in ("h", "v"):
                g_s = getattr(ts, slot)[name]
                j_s = np.asarray(getattr(js, slot)[name], np.float32)
                assert tuple(g_s.shape) == j_s.shape
                assert _rel(g_s, j_s) <= tol, (rnd, name, slot)
        assert float(ts.rounds) == float(js.rounds) == rnd + 1
        assert float(ts.delay_sum) == float(js.delay_sum)
    if inactive:
        assert ts.h["c"].numel() == 0 and ts.v["c"].numel() == 0


def test_init_slots_are_fp32_zeros_like_the_params():
    p = {"x": torch.ones((2, 3), dtype=torch.bfloat16), "y": {"z":
                                                              torch.ones(4)}}
    s = asofed.init_slots(p)
    for t in tree_leaves(s.h) + tree_leaves(s.v):
        assert t.dtype == torch.float32 and not t.any()
    assert s.h["x"].shape == (2, 3) and s.h["x"] is not s.v["x"]
    assert float(s.rounds) == float(s.delay_sum) == 0.0


# ---------------------------------------------------------------------------
# (d) the optimizer library
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.05),
    "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "sgd_cosine": lambda m: m.sgd(m.cosine_schedule(0.1, 2, 6)),
    "adam": lambda m: m.adam(1e-2),
    "adam_wd_cosine": lambda m: m.adam(m.cosine_schedule(1e-2, 2, 6),
                                       weight_decay=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_jax_step_by_step(name):
    """Six steps, each package carrying its own state and parameters; the
    gradients are clipped to a global norm of 1 on each side first."""
    rng = np.random.default_rng(3)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](optimizers)
    init = {k: rng.standard_normal(s, dtype=np.float32)
            for k, s in LEAVES.items()}
    jp, tp = jax.tree.map(jnp.asarray, init), tree_map(torch.tensor, init)
    jst, tst = jo.init(jp), to.init(tp)
    for step in range(6):
        g = {k: rng.standard_normal(s, dtype=np.float32)
             for k, s in LEAVES.items()}
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = optimizers.clip_by_global_norm(tree_map(torch.tensor, g),
                                                1.0)
        assert _rel(tn, jn) <= FP32_TOL
        ju, jst = jo.update(jg, jst, jp)
        tu, tst = to.update(tg, tst, tp)
        jp = jopt.apply_updates(jp, ju)
        tp = optimizers.apply_updates(tp, tu)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for k in LEAVES:
            assert _rel(tu[k], ju[k]) <= FP32_TOL, (step, k)
            assert _rel(tp[k], jp[k]) <= FP32_TOL, (step, k)


def test_clip_and_cosine_schedule_match_jax():
    g = {"a": np.full((3,), 4.0, np.float32), "b": np.full((4,), 3.0,
                                                          np.float32)}
    for max_norm in (0.5, 100.0):
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tc, tn = optimizers.clip_by_global_norm(tree_map(torch.tensor, g),
                                                max_norm)
        assert _rel(tn, jn) <= FP32_TOL
        for k in g:
            assert _rel(tc[k], jc[k]) <= FP32_TOL
    # JAX promotes bf16 leaves against the fp32 scale; so does the port
    tc, _ = optimizers.clip_by_global_norm(
        {"a": torch.ones(3, dtype=torch.bfloat16)}, 0.5)
    assert tc["a"].dtype == torch.float32
    jf, tf_ = jopt.cosine_schedule(0.3, 3, 10), optimizers.cosine_schedule(
        0.3, 3, 10)
    for step in range(13):
        assert _rel(tf_(torch.tensor(step, dtype=torch.int32)),
                    jf(jnp.asarray(step, jnp.int32))) <= FP32_TOL, step


# ---------------------------------------------------------------------------
# (e) the training loop; (g) its checkpoint
# ---------------------------------------------------------------------------

LOOP = dict(steps=8, batch=2, seq=32, eta=3e-3, lam=0.1, beta=0.001,
            seed=0)


def _jax_train_loop(jm, cfg, w_server, streams, *, steps, batch, seq, eta,
                    lam, beta, seed, feature_learning=True):
    """``repro.launch.train.main``'s loop, from the JAX package's own
    functions: (per-step losses, final server weights)."""
    n = len(streams)
    iters = [jlm.batches_from_tokens(s, batch, seq, seed=i)
             for i, s in enumerate(streams)]
    delays = np.random.default_rng(seed).uniform(10.0, 100.0, size=n)
    client_params = [jax.tree.map(jnp.copy, w_server) for _ in range(n)]
    client_server_copy = [w_server for _ in range(n)]
    slots = [jasofed.init_slots(w_server) for _ in range(n)]
    n_k = np.full(n, 1.0)

    @jax.jit
    def local_step(params, server_params, sl, b, delay):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jm.loss(q, b), has_aux=True)(params)
        updates, new_slots = jasofed.asofed_transform(
            grads, sl, params, server_params, lam=lam, beta=beta, eta=eta,
            delay=delay)
        new_params = jax.tree.map(
            lambda q, u: (q.astype(jnp.float32) + u).astype(q.dtype),
            params, updates)
        return new_params, new_slots, loss

    @jax.jit
    def server_fold(w, delta, weight):
        return jax.tree.map(lambda a, d: a - weight * d.astype(a.dtype), w,
                            delta)

    heap = [(float(delays[k]), k) for k in range(n)]
    heapq.heapify(heap)
    losses = []
    for _ in range(steps):
        now, k = heapq.heappop(heap)
        b = {kk: jnp.asarray(v) for kk, v in next(iters[k]).items()}
        before = client_params[k]
        new_p, slots[k], loss = local_step(
            before, client_server_copy[k], slots[k], b,
            jnp.float32(delays[k]))
        delta = jax.tree.map(lambda a, c: a - c, before, new_p)
        n_k[k] += batch * seq
        weight = n_k[k] / n_k.sum()
        w_server = server_fold(w_server, delta, jnp.float32(weight))
        if feature_learning:
            w_server = jfl.apply_feature_learning(w_server, cfg,
                                                  use_kernel=False)
        client_params[k] = jax.tree.map(jnp.copy, w_server)
        client_server_copy[k] = w_server
        heapq.heappush(heap, (now + float(delays[k]), k))
        losses.append(float(loss))
    return losses, w_server


def _assert_tree_close(got, want, tol):
    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {"/".join(path): v for path, v in tree_flatten_with_path(got)}
    assert sorted(got) == sorted(want)
    worst = max(_rel(got[k], want[k]) for k in want)
    assert worst <= tol, worst
    return worst


def _recurrent_layers(cfg) -> int:
    """Mamba or RG-LRU layers of ``cfg``: scan backwards a gradient."""
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return sum(kind == "rglru" for kind in (
            cfg.block_pattern * cfg.n_layers)[:cfg.n_layers])
    return 0


# the plain backward a recurrent layer's gradient takes on the CPU: the
# fused selective scan's (Mamba), LinearScan's (RG-LRU)
SCAN_BACKWARD = {"ssm": "selective_scan_backward_ref",
                 "hybrid": "linear_scan_backward_ref"}


def _count_scan_backwards(monkeypatch):
    """A list that gets one entry per scan backward on the CPU
    (``SelectiveScan``'s or ``LinearScan``'s): (its plain version's name,
    the shape of its first argument)."""
    calls = []
    for name in SCAN_BACKWARD.values():
        ref = getattr(scan_ops, name)

        def spy(*args, _ref=ref, _name=name):
            calls.append((_name, tuple(args[0].shape)))
            return _ref(*args)

        monkeypatch.setattr(scan_ops, name, spy)
    return calls


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("feature_learning", [True, False])
def test_train_loop_matches_the_jax_loop(feature_learning, arch,
                                         monkeypatch):
    """Reduced Qwen2-0.5B (tied embeddings: the feature pass reweights
    the head too), Falcon-Mamba-7B (tied), RecurrentGemma-9B and
    DeepSeek-V2-Lite (MLA and a MoE layer, untied), 3 clients, 8
    steps.  Each client's prox term reads the server as of its
    last pull; a fold or feature pass written in place would rewrite
    those snapshots and part the trajectories.  The Mamba and RG-LRU
    layers' gradients go through SelectiveScan and LinearScan, one
    backward a layer a step."""
    jm, w, tm, p = _pair(arch, cool=True)
    calls = _count_scan_backwards(monkeypatch)
    streams = lm.federated_token_clients(3, tm.cfg.vocab_size, 4_000)
    jstreams = jlm.federated_token_clients(3, tm.cfg.vocab_size, 4_000)
    res = tr.train(tm, p, streams, device="cpu", log=None,
                   feature_learning=feature_learning, **LOOP)
    assert len(calls) == LOOP["steps"] * _recurrent_layers(tm.cfg)
    assert {n for n, _ in calls} <= {SCAN_BACKWARD.get(tm.cfg.family)}
    want_losses, want_w = _jax_train_loop(
        jm, jm.cfg, jax.tree.map(jnp.asarray, w), jstreams,
        feature_learning=feature_learning, **LOOP)
    assert len(set(res["clients"])) == 3
    assert _rel(np.array(res["losses"]), np.array(want_losses)) <= RUN_TOL
    _assert_tree_close(res["params"], want_w, RUN_TOL)
    # the run moved the weights: the comparison is not of the start
    assert _rel(res["params"]["embed"]["table"], w["embed"]["table"]) > 1e-3


# the training CLI's run (4 clients, batch 8 x 128, 40 steps, its eta / lam
# / beta) at reduced Qwen2-0.5B, with the held-out loss of the initial and
# final server weights on one batch a client drawn with seed EVAL_SEED + i
CLI_LOOP = dict(steps=40, batch=8, seq=128, eta=3e-3, lam=0.1, beta=0.001,
                seed=0)
EVAL_SEED = 1000


@pytest.mark.parametrize("feature_learning", [True, False])
def test_train_loop_at_the_cli_settings_matches_the_jax_loop(
        feature_learning, capsys):
    """The CLI's whole run on both sides: every step's loss and the final
    server weights within RUN_TOL, and the held-out loss before and after
    within RUN_TOL.  Printed (``-s``): the held-out change, which shows
    the Eq. (5)-(6) pass after every fold undoing what the steps learn
    (the loss rises with it, falls without it) in the JAX package's loop
    as in the port's."""
    jm, w, tm, p = _pair("qwen2-0.5b", cool=True)
    V = tm.cfg.vocab_size
    streams = lm.federated_token_clients(4, V, 20_000)
    jstreams = jlm.federated_token_clients(4, V, 20_000)
    res = tr.train(tm, p, streams, device="cpu", log=None,
                   feature_learning=feature_learning, **CLI_LOOP)
    want_losses, want_w = _jax_train_loop(
        jm, jm.cfg, jax.tree.map(jnp.asarray, w), jstreams,
        feature_learning=feature_learning, **CLI_LOOP)
    assert _rel(np.array(res["losses"]), np.array(want_losses)) <= RUN_TOL
    _assert_tree_close(res["params"], want_w, RUN_TOL)
    evals = [next(lm.batches_from_tokens(s, CLI_LOOP["batch"],
                                         CLI_LOOP["seq"], seed=EVAL_SEED + i))
             for i, s in enumerate(streams)]
    jloss = jax.jit(lambda q, b: jm.loss(q, b)[0])

    def held_out(port_w, jax_w):
        got = np.mean([float(tm.loss(port_w, {k: torch.from_numpy(v)
                                              for k, v in b.items()})[0])
                       for b in evals])
        want = np.mean([float(jloss(jax_w, {k: jnp.asarray(v)
                                            for k, v in b.items()}))
                        for b in evals])
        assert abs(got - want) / want <= RUN_TOL, (got, want)
        return want

    with torch.no_grad():
        before = held_out(p, jax.tree.map(jnp.asarray, w))
        after = held_out(res["params"], want_w)
    with capsys.disabled():
        print(f"\nCLI settings, feature_learning={feature_learning}: JAX "
              f"loss first {want_losses[0]:.5f} last-10 mean "
              f"{np.mean(want_losses[-10:]):.5f}; held-out {before:.5f} -> "
              f"{after:.5f} ({after - before:+.5f})")


def _wrong_rmsnorm(params, x, eps=1e-6):
    """RMSNorm whose gradient leaves out the variance's dependence on x
    (same values)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True).detach()
    return (x32 * torch.rsqrt(var + eps)
            * params["scale"].to(torch.float32)).to(x.dtype)


def _scaled_scan_backward(da_scale, db_scale):
    """``LinearScan``'s CPU backward with its ``da`` and ``db`` scaled."""
    plain = scan_ops.linear_scan_backward_ref

    def wrong(*args, **kw):
        da, db = plain(*args, **kw)
        return da * da_scale, db * db_scale

    return wrong


def _scaled_selective_backward(dA_scale, db_scale):
    """``SelectiveScan``'s CPU backward with its gradient of A scaled by
    ``dA_scale``, and the gradients that flow through ``dt B x`` to x and
    to B (dxh and the B half of dbc) by ``db_scale``: LinearScan's ``da``
    and ``db`` faults on the fused route."""
    plain = scan_ops.selective_scan_backward_ref

    def wrong(*args, **kw):
        dxh, ddt, dA, dbc = plain(*args, **kw)
        N = dA.shape[1]
        dbc = torch.cat([dbc[..., :N] * db_scale, dbc[..., N:]], dim=-1)
        return dxh * db_scale, ddt, dA * dA_scale, dbc

    return wrong


def _scaled_backward(cfg, da_scale, db_scale):
    """(the name in ops, the wrong plain backward) of ``cfg``'s scan."""
    if cfg.family == "ssm":
        return ("selective_scan_backward_ref",
                _scaled_selective_backward(da_scale, db_scale))
    return "linear_scan_backward_ref", _scaled_scan_backward(da_scale,
                                                             db_scale)


@pytest.mark.parametrize("arch,n_layers,vocab,frac", [
    pytest.param("qwen2-0.5b", 2, 512, "TRAIN_FO_FRAC", id="2-512"),
    pytest.param("qwen2-0.5b", 4, 8192, "TRAIN_FO_FRAC", id="4-8192"),
    pytest.param("falcon-mamba-7b", 4, 8192, "TRAIN_FO_FRAC_SSM",
                 id="falcon-mamba-7b-4-8192")])
def test_chip_smoke_first_step_gate(arch, n_layers, vocab, frac,
                                    monkeypatch, capsys):
    """``chip_smoke.py``'s first-step gate (``train_path``'s over
    ``TRAIN_FO_FRAC`` of the step, ``train_path_mamba``'s over
    ``TRAIN_FO_FRAC_SSM``), run on the CPU at reduced width: client 0's
    first local step lowers its batch's loss, and its central difference
    is the first-order prediction <g, u> within ``TRAIN_FO_TOL``; a wrong
    gradient fails it (RMSNorm's variance left out of it; on Falcon-Mamba
    the gradients through the scan's ``dt B x`` to x and B scaled by 0.9
    in ``SelectiveScan``'s backward), and so does a step of the wrong
    sign.  Printed (``-s``): the ratios."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEV", "cpu")
    frac = getattr(cs, frac)
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              n_layers=n_layers, vocab_size=vocab)
    model = build_model(cfg)
    params = cs._cool_attention(model.init(torch.Generator().manual_seed(0),
                                           device="cpu"))
    streams = cs._train_streams(cs.TRAIN_CLIENTS, vocab, 5_000)

    passes = cs._first_step_ok
    right = cs._first_step_check(model, params, streams, frac)
    assert passes(right), right
    with monkeypatch.context() as m:
        if cfg.family == "ssm":
            m.setattr(scan_ops, *_scaled_backward(cfg, 1.0, 0.9))
        else:
            m.setattr(layers, "rmsnorm", _wrong_rmsnorm)
        wrong = cs._first_step_check(model, params, streams, frac)
    assert wrong["loss_before"] == right["loss_before"]
    assert not passes(wrong), wrong
    with monkeypatch.context() as m:
        m.setitem(cs.TRAIN_HYPER, "eta", -cs.TRAIN_HYPER["eta"])
        uphill = cs._first_step_check(model, params, streams, frac)
    assert not passes(uphill), uphill
    with capsys.disabled():
        print(f"\nfirst-step gate, {arch}, {n_layers} layers, vocab "
              f"{vocab}, fraction {frac}: ratio {right['ratio']:.5f} (whole "
              f"step {right['ratio_whole_step']:.5f}); wrong gradient "
              f"{wrong['ratio']:.5f}")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_chip_smoke_gradient_gap_sees_the_scan_da(arch, monkeypatch):
    """``train_card_vs_cpu``'s gradient check (``_grad_gaps`` within
    ``TRAIN_TOL``) at reduced width, 2 x 32 tokens: the scan's gradient
    of its decay scaled by 1.001 in its CPU backward (``SelectiveScan``'s
    dA, ``LinearScan``'s da) lies past the tolerance on the recurrence's
    leaves, which the first-step gate cannot see."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = cs._cool_attention(model.init(torch.Generator().manual_seed(0),
                                           device="cpu"))
    paths = ["/".join(p) for p, _ in tree_flatten_with_path(params)]
    batch = make_batch(cfg, 2, 32, seed=0, device="cpu")
    _, right = cs._grad(model, params, batch)
    assert max(cs._grad_gaps(paths, right, right).values()) == 0.0
    with monkeypatch.context() as m:
        m.setattr(scan_ops, *_scaled_backward(cfg, 1.001, 1.0))
        _, wrong = cs._grad(model, params, batch)
    gaps = cs._grad_gaps(paths, wrong, right)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] > 3 * cs.TRAIN_TOL, gaps
    assert worst.split("/")[-1] in ("A_log", "lam", "w_a"), worst


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("gathered", [False, True],
                         ids=["all_experts", "gathered"])
def test_chip_smoke_forced_routing(arch, gathered, monkeypatch):
    """``chip_smoke.Routing`` at reduced width, 2 x 32 tokens (every
    expert at once, or the gathered rows with their host read of the
    counts): forcing a run's own expert ids gives its loss and every
    gradient leaf bit for bit, with no flip counted; one token's id
    moved to an expert outside its set counts one flip, at its layer's
    call, and changes the loss."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    if gathered:
        monkeypatch.setattr(moe_lib, "ALL_EXPERTS_MAX_TOKENS", 0)
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = cs._cool_attention(model.init(torch.Generator().manual_seed(0),
                                           device="cpu"))
    batch = make_batch(cfg, 2, 32, seed=0, device="cpu")
    want_loss, want = cs._grad(model, params, batch)
    with cs.Routing() as rec:
        loss, g = cs._grad(model, params, batch)
    n_moe = cs._moe_layers(cfg)
    assert rec.calls == len(rec.ids) == n_moe and not rec.flips
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(g, want))
    with cs.Routing(rec.ids) as forced:
        loss, g = cs._grad(model, params, batch)
    assert forced.calls == n_moe and forced.flips == [0] * n_moe
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(g, want))
    assert moe_lib._route is not forced.route  # restored
    ids = [t.clone() for t in rec.ids]
    E = cfg.n_experts
    outside = next(e for e in range(E) if e not in ids[-1][5].tolist())
    ids[-1][5, 0] = outside
    with cs.Routing(ids) as moved:
        loss, _ = cs._grad(model, params, batch)
    assert moved.flips == [0] * (n_moe - 1) + [1]
    assert cs._flips_by_layer(moved.flips * 2, n_moe) == \
        [0] * (n_moe - 1) + [2]
    assert not torch.equal(loss, want_loss)


def test_train_witness_fp64_leaves_no_float32(monkeypatch):
    """``train_witness.py``'s fp64 gradient on reduced RecurrentGemma
    (cooled, as its phases run): every leaf in fp64, no float32 tensor
    made on the way, the loss the fp32 one's within 1e-6, and the fp32
    gradient within ``TRAIN_TOL`` of it per leaf."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs
    import train_witness as tw

    cfg = get_arch("recurrentgemma-9b").reduced()
    model = build_model(cfg)
    params = cs._cool_attention(model.init(torch.Generator().manual_seed(0),
                                           device="cpu"))
    paths = ["/".join(p) for p, _ in tree_flatten_with_path(params)]
    batch = make_batch(cfg, 1, 32, seed=0, device="cpu")
    loss, g = cs._grad(model, params, batch)
    wide_loss, wide, seen = tw.grad_fp64(model, params, batch)
    assert seen == 0
    assert torch.get_default_dtype() == torch.float32
    assert {x.dtype for x in wide} == {torch.float64}
    assert wide_loss.dtype == torch.float64
    assert abs(float(loss) - float(wide_loss)) <= 1e-6 * abs(float(wide_loss))
    assert max(cs._grad_gaps(paths, g, wide).values()) <= cs.TRAIN_TOL


def test_train_main_checkpoint_loads_in_jax(tmp_path, capsys):
    """``--checkpoint`` writes the final server weights in the JAX
    package's layout: ``repro.checkpoint.load_checkpoint`` reads them
    back bit for bit.  The CLI prints the JAX training script's lines."""
    ck = str(tmp_path / "ck")
    rec = tr.main(["--reduced", "--device", "cpu", "--clients", "1",
                   "--steps", "2", "--batch", "2", "--seq", "16",
                   "--checkpoint", ck])
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2-0.5b reduced=True vocab=512 d=256 L=2")
    assert "iter    1 client 0 loss" in out and f"saved checkpoint to {ck}" \
        in out
    assert set(rec) >= {"final_loss_avg10", "first_loss"}
    like = jax.tree.map(
        np.asarray, jax_build_model(jax_get_arch("qwen2-0.5b").reduced(),
                                    LOCAL).init(jax.random.PRNGKey(0)))
    loaded, step = load_checkpoint(ck, like)
    assert step == 2
    _assert_tree_close(rec["params"], loaded, 0.0)


# ---------------------------------------------------------------------------
# (f) the quickstart path
# ---------------------------------------------------------------------------


def _example():
    spec = importlib.util.spec_from_file_location(
        "quickstart_example", os.path.join(ROOT, "examples", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_jax_example():
    """The example's loop (its constants read from the example itself) on
    the JAX side, ``repro_torch.launch.quickstart`` from the same weights
    on the port's: per-round losses, and the central model's prefill
    logits (logits, not argmax tokens, which flip on near ties)."""
    ex = _example()
    assert (ex.ARCH, ex.CLIENTS, ex.ROUNDS, ex.SEQ, ex.BATCH, ex.ETA,
            ex.LAM, ex.BETA) == (qs.ARCH, qs.CLIENTS, qs.ROUNDS, qs.SEQ,
                                 qs.BATCH, qs.ETA, qs.LAM, qs.BETA)
    cfg = jax_get_arch(ex.ARCH).reduced()
    jm = jax_build_model(cfg, LOCAL)
    w0 = _cooled(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    got = qs.quickstart(params_from_numpy(w0, device="cpu"), device="cpu",
                        log=None)
    w0 = jax.tree.map(jnp.asarray, w0)

    streams = jlm.federated_token_clients(ex.CLIENTS, cfg.vocab_size, 50_000)
    iters = [jlm.batches_from_tokens(s, ex.BATCH, ex.SEQ, seed=i)
             for i, s in enumerate(streams)]
    delays = np.random.default_rng(0).uniform(10, 100, ex.CLIENTS)
    slots = [jasofed.init_slots(w0) for _ in range(ex.CLIENTS)]
    n_k = np.ones(ex.CLIENTS)

    @jax.jit
    def local_step(params, server, sl, batch, delay):
        (loss, _), g = jax.value_and_grad(
            lambda q: jm.loss(q, batch), has_aux=True)(params)
        upd, sl = jasofed.asofed_transform(g, sl, params, server,
                                           lam=ex.LAM, beta=ex.BETA,
                                           eta=ex.ETA, delay=delay)
        return jax.tree.map(lambda q, u: (q + u).astype(q.dtype), params,
                            upd), sl, loss

    w = w0
    heap = [(delays[k], k) for k in range(ex.CLIENTS)]
    heapq.heapify(heap)
    losses = []
    for _ in range(ex.ROUNDS):
        now, k = heapq.heappop(heap)
        batch = {kk: jnp.asarray(v) for kk, v in next(iters[k]).items()}
        new_w, slots[k], loss = local_step(w, w, slots[k], batch,
                                           jnp.float32(delays[k]))
        n_k[k] += ex.BATCH * ex.SEQ
        weight = n_k[k] / n_k.sum()
        w = jax.tree.map(lambda a, old, new: a - weight * (old - new), w, w,
                         new_w)
        w = jfl.apply_feature_learning(w, cfg)
        heapq.heappush(heap, (now + delays[k], k))
        losses.append(float(loss))
    prompt = {"tokens": jnp.asarray(streams[0][:ex.SEQ])[None],
              "labels": jnp.zeros((1, ex.SEQ), jnp.int32)}
    logits, _ = jm.prefill(w, prompt, max_len=ex.SEQ + 8)

    assert _rel(np.array(got["losses"]), np.array(losses)) <= RUN_TOL
    assert _rel(got["prefill_logits"], logits) <= RUN_TOL
    assert len(got["generated"]) == 8


# ---------------------------------------------------------------------------
# (h) the refusals, the first layer and the feature pass
# ---------------------------------------------------------------------------


def test_k3_wrapper_refuses_inputs_that_require_grad():
    q = torch.zeros((1, 4, 1, 1, 32), requires_grad=True)
    k = torch.zeros((1, 4, 1, 32))
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(RuntimeError, match="flash_attention_kernel has no "
                       "backward.*attention='blocked'"):
        flash_attention_kernel(q, k, k, pos, pos, causal=True, window=0,
                               contiguous=True)
    with torch.no_grad():  # no autograd: the usual checks (needs CUDA)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            flash_attention_kernel(q, k, k, pos, pos, causal=True, window=0,
                                   contiguous=True)


def test_k2_wrapper_refuses_inputs_that_require_grad():
    a = torch.zeros((1, 4, 8))
    b = torch.zeros((1, 4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="linear_scan_kernel returns "
                       "states with no autograd history.*ops.linear_scan, "
                       "the differentiable route"):
        linear_scan_kernel(a, b)
    with torch.no_grad():
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            linear_scan_kernel(a, b)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_ssm_and_hybrid_train_on_the_cpu(arch, monkeypatch):
    """Their gradients come through SelectiveScan (Mamba) and LinearScan
    (RG-LRU), whose CPU backwards are the plain versions: one backward a
    recurrent layer, at the layer's (B, S, C) shape (xh's, d_inner wide,
    for the fused scan), and every leaf gets a finite gradient."""
    _, _, tm, p = _pair(arch)
    calls = _count_scan_backwards(monkeypatch)
    _, _, g = _port_grad(tm, p, make_batch(tm.cfg, B, S, seed=1,
                                           device="cpu"))
    C = (tm.cfg.d_inner if tm.cfg.family == "ssm" else tm.cfg.lru_width)
    assert calls == [(SCAN_BACKWARD[tm.cfg.family], (B, S, C))] * \
        _recurrent_layers(tm.cfg)
    assert all(torch.isfinite(t).all() for t in tree_leaves(g))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_first_layer_path_is_jax_s(arch):
    assert fl.first_layer_path(get_arch(arch)) == jfl.first_layer_path(
        jax_get_arch(arch)) == ("embed", "table")


def test_first_layer_path_of_the_paper_models_and_unknown_families():
    assert fl.first_layer_path(paper_lstm()) == ("w_x",)
    assert fl.first_layer_path(paper_cnn()) == ("conv1_w",)
    bad = dataclasses.replace(get_arch("qwen2-0.5b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        fl.first_layer_path(bad)


def test_feature_pass_on_a_tied_embedding_matches_jax():
    """The pass reweights the (vocab, d) embedding, which is also the
    head; the other leaves are the same tensors, untouched."""
    jm, w, tm, p = _pair("qwen2-0.5b")
    want = jfl.apply_feature_learning(jax.tree.map(jnp.asarray, w), jm.cfg,
                                      use_kernel=False)
    before = p["embed"]["table"].clone()
    got = fl.apply_feature_learning(p, tm.cfg)
    assert torch.equal(p["embed"]["table"], before)  # out of place
    assert got["final_norm"]["scale"] is p["final_norm"]["scale"]
    assert got["embed"]["table"] is not p["embed"]["table"]
    _assert_tree_close(got, want, FP32_TOL)


@pytest.mark.parametrize("entry", ["train", "train_main", "quickstart",
                                   "quickstart_main"])
def test_training_entry_points_default_to_the_card(entry):
    """Without a device the training entry points ask for the CUDA card,
    and raise where there is none rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    tm = build_model(get_arch("qwen2-0.5b").reduced())
    calls = {
        "train": lambda: tr.train(tm, {}, [np.zeros(64, np.int32)],
                                  steps=1, log=None),
        "train_main": lambda: tr.main(["--reduced", "--steps", "1"]),
        "quickstart": lambda: qs.quickstart(log=None),
        "quickstart_main": lambda: qs.main([]),
    }
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        calls[entry]()
