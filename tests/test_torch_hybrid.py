"""RecurrentGemma-9B (RG-LRU + local MQA hybrid) in the port against the
JAX package.

At the ``reduced()`` size (d_model 256, 4 heads over 1 KV head, head dim
64, d_ff 512, vocab 512, lru_width 256, local window 64), from the JAX
package's own weights (``jax.tree.map(np.asarray, jmodel.init(...))``
through ``params_from_numpy``) and numpy inputs.  The model-level cases
run 4 layers, one (rglru, rglru, attn) superblock and a one-layer tail,
on an 80-token prompt: longer than the window, so the prefill packs the
attention ring through ``_kv_to_cache``'s circular branch and every
decode step wraps it.  The JAX side runs under both of its kernel
settings, ``attention_impl`` / ``scan_impl`` = ``"xla"`` (XLA's
attention and ``chunked_linear_scan``) and ``"pallas_interpret"`` (the
K3 and K2 Pallas kernels in interpret mode); the port runs on the CPU,
where K2 and K3 take their plain versions.

Tolerances, per unit of the reference's largest magnitude: fp32 ``TOL``
= 5e-4, as ``tests/test_torch_ssm.py``; the frameworks' sum orders
differ at the 1e-6 level.  bf16 holds at that file's bounds and method
(the same fp32 numpy weights cast to bf16 on each side): 0.15 for
logits, 4e-2 for the caches, where bf16 is conditioned (see
``test_bf16_prefill_matches_jax``).  Positions (``pos``) are equal
exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_kernel)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.decode import INT_SENTINEL, _commit_kv  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

ARCH = "recurrentgemma-9b"
IMPLS = ["xla", "pallas_interpret"]
N_LAYERS = 4  # one superblock and a one-layer tail
B, S = 2, 80  # S > the reduced local window (64)
STEPS = 4
TOL = 5e-4
CONSISTENCY_TOL = 5e-3
BF16_TOL = {"logits": 0.15, "cache": 4e-2}
DRAWS = (6, 0, 1)


def _cfgs(n_layers=N_LAYERS, **kw):
    """(JAX config, port config): reduced, at ``n_layers``."""
    return tuple(dataclasses.replace(get(ARCH).reduced(), n_layers=n_layers,
                                     **kw)
                 for get in (jax_get_arch, get_arch))


def _dist(impl):
    return dataclasses.replace(LOCAL, attention_impl=impl, scan_impl=impl)


def _pair(impl="xla", seed=0, n_layers=N_LAYERS, **kw):
    """(JAX model, numpy weights, port model, port CPU weights)."""
    jcfg, tcfg = _cfgs(n_layers, **kw)
    jm = jax_build_model(jcfg, _dist(impl))
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, w, build_model(tcfg), params_from_numpy(w, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-6)


def _tokens(vocab, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, n)).astype(np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                       f"{prefix}/{k}")]


def _assert_cache(got, want, tol, tag):
    """Every leaf of the hybrid cache: ``pos`` equal, the rest within
    ``tol`` per unit."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], tag
    for (path, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == tuple(wl.shape), f"{tag} {path}"
        if gl.numel() == 0:  # zero superblocks stack to empty leaves
            continue
        if path.endswith("pos"):
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl),
                                          err_msg=f"{tag} {path}")
        else:
            err = _rel(gl, wl)
            assert err < tol, f"{tag}: {path} differs by {err}"


def _layer0_mix(w, p, name="r1"):
    """Superblock 0's mixer ``name``: (JAX arrays, port tensors)."""
    return (jax.tree.map(lambda a: jnp.asarray(a[0]),
                         w["superblocks"][name]["mix"]),
            layer(p["superblocks"], 0)[name]["mix"])


@pytest.fixture(scope="module", params=IMPLS)
def run(request):
    """One JAX run per kernel setting: predict, prefill and STEPS
    teacher-forced decode steps, all jitted, on the tokens the port
    gets."""
    jm, w, tm, p = _pair(request.param)
    toks = _tokens(jm.cfg.vocab_size, S + STEPS)
    prompt = {"tokens": jnp.asarray(toks[:, :S])}
    logits = jax.jit(jm.predict)(w, prompt)
    pre_logits, cache = jax.jit(
        lambda w, b: jm.prefill(w, b, max_len=S + STEPS))(w, prompt)
    decode = jax.jit(jm.decode_step)
    steps, c = [], cache
    for i in range(STEPS):
        lg, c = decode(w, c, jnp.asarray(toks[:, S + i:S + i + 1]),
                       jnp.full((B,), S + i, jnp.int32))
        steps.append((lg, c))
    return dict(tm=tm, p=p, toks=toks, logits=logits, pre_logits=pre_logits,
                cache=cache, steps=steps)


# -- config, spec and weights ------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_jax(size):
    t, j = get_arch(ARCH), jax_get_arch(ARCH)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    want = ((38, 4096, 16, 1, 256, 12288, 256000, 2048, 4096)
            if size == "full" else (3, 256, 4, 1, 64, 512, 512, 64, 256))
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.head_dim,
            t.d_ff, t.vocab_size, t.local_window, t.lru_width) == want
    assert (t.family, t.block_pattern, t.tie_embeddings) == (
        "hybrid", ("rglru", "rglru", "attn"), False)


@pytest.mark.parametrize("n_layers", [3, 5], ids=["one_superblock",
                                                  "with_tail"])
def test_params_cross_leaf_for_leaf(n_layers):
    """The port's spec has every leaf of the JAX tree with its shape, its
    init draws them, and ``params_from_numpy`` carries the JAX weights
    across under the same paths (copies, not views)."""
    jm, w, tm, p = _pair(n_layers=n_layers)
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    drawn = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert len(flat_j) == len(_leaves(p)) == len(_leaves(drawn))
    for path, arr in flat_j:
        t, d = p, drawn
        for k in path:
            t, d = t[k.key], d[k.key]
        np.testing.assert_array_equal(t.numpy(), arr)
        assert tuple(d.shape) == arr.shape and d.dtype == torch.float32
    assert ("tail" in w) == ("tail" in p) == (n_layers == 5)
    n_super = n_layers // 3
    assert tuple(p["superblocks"]["a"]["mix"]["wk"].shape) == (
        n_super, 256, 1, 64)
    lam = drawn["superblocks"]["r1"]["mix"]["lam"]
    assert float(lam.abs().max()) <= 1.0 and float(lam.min()) < -0.9
    p["superblocks"]["r1"]["mix"]["lam"].add_(1.0)
    assert not np.allclose(p["superblocks"]["r1"]["mix"]["lam"].numpy(),
                           w["superblocks"]["r1"]["mix"]["lam"])


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs(5)
    for max_len in (40, 1000):
        want = jdec.init_cache(jcfg, B, max_len, jnp.float32)
        got = build_model(tcfg).init_cache(B, max_len, torch.float32,
                                           device="cpu")
        g, w = _leaves(got), _leaves(want)
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, gl), (_, wl) in zip(g, w):
            assert tuple(gl.shape) == wl.shape, path
            np.testing.assert_array_equal(_np(gl), _np(wl))
        assert got["super"]["a"]["k"].shape[2] == min(max_len, 64)


# -- the RG-LRU block --------------------------------------------------------


def test_gates_matches_jax():
    _, w, tm, p = _pair()
    jp, tp = _layer0_mix(w, p)
    xc = _normal((B, 9, tm.cfg.lru_width), 3)
    ja, jb = jrglru._gates(jp, jnp.asarray(xc))
    a, b = rglru._gates(tp, torch.tensor(xc))
    assert a.dtype == b.dtype == torch.float32
    assert _rel(a, ja) < TOL and _rel(b, jb) < TOL
    assert 0.0 < float(a.min()) and float(a.max()) < 1.0


@pytest.mark.parametrize("impl", IMPLS)
def test_rglru_forward_with_state_matches_jax(impl):
    jm, w, tm, p = _pair(impl)
    jp, tp = _layer0_mix(w, p)
    x = _normal((B, S, tm.cfg.d_model), 7)
    want, jst = jrglru.rglru_forward(jp, jnp.asarray(x), jm.cfg,
                                     _dist(impl), return_state=True)
    got, st = rglru.rglru_forward(tp, torch.tensor(x), tm.cfg,
                                  return_state=True)
    assert _rel(got, want) < TOL
    assert st["h"].dtype == torch.float32
    assert tuple(st["conv"].shape) == (B, 3, tm.cfg.lru_width)
    _assert_cache(st, jst, TOL, impl)
    assert torch.equal(rglru.rglru_forward(tp, torch.tensor(x), tm.cfg), got)


def test_rglru_decode_matches_jax():
    jm, w, tm, p = _pair()
    jp, tp = _layer0_mix(w, p, "r2")
    cfg = tm.cfg
    x = _normal((B, 1, cfg.d_model), 8)
    h = _normal((B, cfg.lru_width), 9)
    conv = _normal((B, 3, cfg.lru_width), 10)
    want, jst = jrglru.rglru_decode(
        jp, jnp.asarray(x), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        jm.cfg, LOCAL)
    state = {"h": torch.tensor(h), "conv": torch.tensor(conv)}
    got, st = rglru.rglru_decode(tp, torch.tensor(x), state, cfg)
    assert _rel(got, want) < TOL
    _assert_cache(st, jst, TOL, "decode")
    assert np.array_equal(state["h"].numpy(), h)  # read, not written
    zero = rglru.rglru_init_state(cfg, B, torch.float32, "cpu")
    jzero = jrglru.rglru_init_state(jm.cfg, B, jnp.float32)
    for name in ("h", "conv"):
        assert tuple(zero[name].shape) == jzero[name].shape
        assert not zero[name].any()


def test_deferred_commit_equals_immediate_write_on_wrapped_ring():
    """The port's hybrid decode attends with the new token as an extra
    column and commits its K/V after the layer loop; JAX's writes the slot
    first (``gqa_decode(defer_write=False)``).  On a full ring of
    ``local_window`` slots whose slot ``cur % slots`` holds the position a
    whole window back, both give the same output and the same ring."""
    jm, w, tm, p = _pair()
    jp, tp = _layer0_mix(w, p, "a")
    cfg, win = tm.cfg, tm.cfg.local_window
    slots, KV, hd = win, cfg.n_kv_heads, cfg.head_dim
    cur = np.array([134, 3 * win + 5], np.int32)  # wrapped rings
    pos = np.stack([np.arange(c - slots, c) for c in cur])  # a full window
    ring_pos = np.empty_like(pos, dtype=np.int32)
    for b in range(B):
        ring_pos[b, pos[b] % slots] = pos[b]
    k = _normal((B, slots, KV, hd), 11)
    v = _normal((B, slots, KV, hd), 12)
    x = _normal((B, 1, cfg.d_model), 13)
    want, jc = jattn.gqa_decode(
        jp, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                             "pos": jnp.asarray(ring_pos)},
        jnp.asarray(cur), jm.cfg, LOCAL, window=win)
    ring = {"k": torch.tensor(k), "v": torch.tensor(v),
            "pos": torch.tensor(ring_pos)}
    got, (kn, vn) = attn.gqa_decode(tp, torch.tensor(x), ring,
                                    torch.tensor(cur), cfg, window=win,
                                    defer_write=True)
    stacked = {n: t[None].clone() for n, t in ring.items()}
    _commit_kv(stacked, kn[None], vn[None], torch.tensor(cur))
    assert _rel(got, want) < TOL
    _assert_cache({n: t[0] for n, t in stacked.items()}, jc, TOL, "ring")
    # the slot written is the one the window had just let go
    for b in range(B):
        assert int(stacked["pos"][0, b, cur[b] % slots]) == cur[b]


# -- the model ---------------------------------------------------------------


def test_predict_matches_jax(run):
    got = run["tm"].predict(run["p"], {"tokens": torch.tensor(
        run["toks"][:, :S])})
    assert _rel(got, run["logits"]) < TOL


def test_prefill_matches_jax(run):
    """The prompt is longer than the window: the ring holds the last
    ``local_window`` positions at their circular slots."""
    logits, cache = run["tm"].prefill(
        run["p"], {"tokens": torch.tensor(run["toks"][:, :S])},
        max_len=S + STEPS)
    assert _rel(logits, run["pre_logits"]) < TOL
    _assert_cache(cache, run["cache"], TOL, "prefill")
    ring = cache["super"]["a"]["pos"][0]
    assert int(ring.min()) == S - 64 and int(ring.max()) == S - 1
    assert torch.equal(ring[:, (S - 1) % 64], torch.full((B,), S - 1,
                                                         dtype=torch.int32))


def test_decode_steps_match_jax(run):
    """STEPS teacher-forced steps, each wrapping the ring; each writes its
    state and K/V into the cache it is given."""
    tm, p, toks = run["tm"], run["p"], run["toks"]
    _, cache = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S])},
                          max_len=S + STEPS)
    k = cache["super"]["a"]["k"]
    h = cache["tail"]["h"]
    for i, (jl, jc) in enumerate(run["steps"]):
        logits, cache2 = tm.decode_step(
            p, cache, torch.tensor(toks[:, S + i:S + i + 1]),
            torch.full((B,), S + i, dtype=torch.int32))
        assert cache2 is cache and cache["super"]["a"]["k"] is k
        assert cache["tail"]["h"] is h  # in place
        assert _rel(logits, jl) < TOL, f"step {i}"
        _assert_cache(cache, jc, TOL, f"step {i}")


def test_decode_past_window_matches_jax():
    """A 40-token prompt (the ring's padded branch) and 30 teacher-forced
    steps to position 69: the ring fills at 64 and wraps, each step held
    against JAX's decode, which writes the slot before attending."""
    S0, steps = 40, 30
    jm, w, tm, p = _pair()
    toks = _tokens(jm.cfg.vocab_size, S0 + steps, seed=4)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S0 + steps))(
        w, {"tokens": jnp.asarray(toks[:, :S0])})
    tl, tc = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S0])},
                        max_len=S0 + steps)
    assert _rel(tl, jl) < TOL
    assert int((tc["super"]["a"]["pos"] == INT_SENTINEL).sum()) == \
        B * (64 - S0)
    decode = jax.jit(jm.decode_step)
    for i in range(steps):
        tok, idx = toks[:, S0 + i:S0 + i + 1], S0 + i
        jl, jc = decode(w, jc, jnp.asarray(tok), jnp.full((B,), idx,
                                                         jnp.int32))
        tl, tc = tm.decode_step(p, tc, torch.tensor(tok),
                                torch.full((B,), idx, dtype=torch.int32))
        assert _rel(tl, jl) < TOL, f"step {i}"
    _assert_cache(tc, jc, TOL, "after the wrap")
    assert int(tc["super"]["a"]["pos"].min()) == S0 + steps - 64


# the leaves of the 4-layer bf16 cache computed before the attention
# layer's output: superblock 0's RG-LRU states and the ring's K/V
BF16_PRE_ATTENTION = ("/super/a/k", "/super/a/v", "/super/r1/conv",
                      "/super/r1/h", "/super/r2/conv", "/super/r2/h")


def _bf16(w, p):
    return (jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), w),
            tree_map(lambda t: t.to(torch.bfloat16), p))


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_prefill_matches_jax(impl):
    """Served in bf16: the JAX package's fp32 numpy weights cast to bf16
    on each side, prefill and one decode step on each of DRAWS' token
    draws.  The LRU ``h`` stays fp32 on both sides, the rest bf16.

    Held at ``BF16_TOL`` where bf16 is conditioned: every cache leaf
    computed before the attention layer's output (measured at most
    1.4e-2).  Past it the reduced model's random-init local attention is
    near one-hot (|scores| up to ~550 on this prompt), so one bf16
    rounding of q or k flips the winner of a near-tied row in either
    package: the JAX package's own bf16 prefill lies 0.013-0.625 per unit
    from its fp32 one in the logits and 0.024-0.52 in the tail's state
    over these and five more draws, and the port's bf16 logits lie
    0.009-0.34 from the JAX package's.  There the two are held to be
    finite and of the served dtypes; bf16 logits end to end are held in
    ``test_bf16_logits_without_attention_match_jax``."""
    jm, w, tm, p = _pair(impl)
    wj, pt = _bf16(w, p)
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 1))
    decode = jax.jit(jm.decode_step)
    idx = np.full((B,), S, np.int32)
    for seed in DRAWS:
        toks = _tokens(jm.cfg.vocab_size, S + 1, seed=seed)
        jl, jc = prefill(wj, {"tokens": jnp.asarray(toks[:, :S])})
        tl, tc = tm.prefill(pt, {"tokens": torch.tensor(toks[:, :S])},
                            max_len=S + 1)
        assert tl.dtype == torch.bfloat16
        assert tc["tail"]["h"].dtype == tc["super"]["r1"]["h"].dtype \
            == torch.float32
        assert tc["super"]["a"]["k"].dtype == torch.bfloat16
        assert tc["tail"]["conv"].dtype == torch.bfloat16
        assert torch.isfinite(tl.to(torch.float32)).all()
        got, want = dict(_leaves(tc)), dict(_leaves(jc))
        _assert_cache({k: got[k] for k in BF16_PRE_ATTENTION},
                      {k: want[k] for k in BF16_PRE_ATTENTION},
                      BF16_TOL["cache"], f"draw {seed} prefill")
        np.testing.assert_array_equal(got["/super/a/pos"].numpy(),
                                      np.asarray(want["/super/a/pos"]))
        tl, tc = tm.decode_step(pt, tc, torch.tensor(toks[:, S:]),
                                torch.tensor(idx))
        assert tl.dtype == torch.bfloat16
        assert torch.isfinite(tl.to(torch.float32)).all()


def test_bf16_logits_without_attention_match_jax():
    """bf16 end to end where no attention layer intervenes: the hybrid
    at 2 layers has zero superblocks (``divmod(2, 3)``), only a tail of
    two RG-LRU layers.  Prefill logits and state, and one decode step, on
    each of DRAWS' token draws, at ``BF16_TOL``."""
    jm, w, tm, p = _pair(n_layers=2)
    # JAX stacks zero superblocks: empty leaves
    assert p["superblocks"]["a"]["mix"]["wq"].shape[0] == 0
    assert tuple(p["tail"]["ln1"]["scale"].shape) == (2, 256)
    wj, pt = _bf16(w, p)
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 1))
    decode = jax.jit(jm.decode_step)
    idx = np.full((B,), S, np.int32)
    for seed in DRAWS:
        toks = _tokens(jm.cfg.vocab_size, S + 1, seed=seed)
        jl, jc = prefill(wj, {"tokens": jnp.asarray(toks[:, :S])})
        tl, tc = tm.prefill(pt, {"tokens": torch.tensor(toks[:, :S])},
                            max_len=S + 1)
        assert tl.dtype == torch.bfloat16
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed}"
        _assert_cache(tc, jc, BF16_TOL["cache"], f"draw {seed} prefill")
        jl, jc = decode(wj, jc, jnp.asarray(toks[:, S:]), jnp.asarray(idx))
        tl, tc = tm.decode_step(pt, tc, torch.tensor(toks[:, S:]),
                                torch.tensor(idx))
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed} decode"
        _assert_cache(tc, jc, BF16_TOL["cache"], f"draw {seed} decode")


@pytest.mark.parametrize("impl", IMPLS)
def test_head_dim_256_matches_jax(impl):
    """The card's head dim on a narrow config: reduced, 3 layers, with
    ``head_dim=256`` set (4 heads over 1 KV head), prefill and two decode
    steps against JAX (its Pallas attention at hd 256 under
    ``pallas_interpret``)."""
    jm, w, tm, p = _pair(impl, n_layers=3, head_dim=256)
    assert tm.cfg.head_dim == jm.cfg.head_dim == 256
    toks = _tokens(jm.cfg.vocab_size, S + 2, seed=5)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 2))(
        w, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S])},
                        max_len=S + 2)
    assert tuple(tc["super"]["a"]["k"].shape) == (1, B, 64, 1, 256)
    assert _rel(tl, jl) < TOL
    _assert_cache(tc, jc, TOL, "hd256 prefill")
    decode = jax.jit(jm.decode_step)
    for i in range(2):
        tok, idx = toks[:, S + i:S + i + 1], S + i
        jl, jc = decode(w, jc, jnp.asarray(tok), jnp.full((B,), idx,
                                                         jnp.int32))
        tl, tc = tm.decode_step(p, tc, torch.tensor(tok),
                                torch.full((B,), idx, dtype=torch.int32))
        assert _rel(tl, jl) < TOL, f"step {i}"
    _assert_cache(tc, jc, TOL, "hd256 decode")


def test_prefill_then_decode_matches_forward():
    """The port's own teacher-forcing consistency, as
    tests/test_decode_consistency.py holds the JAX package's: prefill on
    S - 1 tokens and one decode step reproduce the forward's logits at
    positions S - 2 and S - 1 (past the window: the forward's attention
    is windowed too)."""
    _, _, tm, p = _pair()
    batch = make_batch(tm.cfg, B, S, seed=3, device="cpu")
    full = tm.predict(p, batch)
    scale = float(full.abs().max())
    logits_p, cache = tm.prefill(p, {"tokens": batch["tokens"][:, :S - 1]},
                                 max_len=S + 8)
    assert float((logits_p - full[:, S - 2]).abs().max()) / scale \
        < CONSISTENCY_TOL
    logits_d, _ = tm.decode_step(
        p, cache, batch["tokens"][:, S - 1:],
        torch.full((B,), S - 1, dtype=torch.int32))
    assert float((logits_d - full[:, S - 1]).abs().max()) / scale \
        < CONSISTENCY_TOL


def test_serve_on_cpu_launches_no_kernel():
    """serve(device="cpu") greedy equals the port's own prefill and greedy
    decode, and counts no kernel launch on the CPU."""
    gen = 3
    _, _, tm, p = _pair()
    prompt = _tokens(tm.cfg.vocab_size, S, seed=2)
    k2, k3 = linear_scan_kernel.launches, flash_attention_kernel.launches
    got, stats = serve(tm, p, torch.tensor(prompt), gen, device="cpu")
    assert (linear_scan_kernel.launches, flash_attention_kernel.launches) \
        == (k2, k3)
    assert stats["k2_launches"] == stats["k3_launches"] == 0
    assert stats["finite_logits"] and tuple(got.shape) == (B, gen + 1)
    logits, cache = tm.prefill(p, {"tokens": torch.tensor(prompt)},
                               max_len=S + gen)
    want = [torch.argmax(logits, -1)]
    for i in range(gen):
        logits, cache = tm.decode_step(
            p, cache, want[-1][:, None].to(torch.int32),
            torch.full((B,), S + i, dtype=torch.int32))
        want.append(torch.argmax(logits, -1))
    assert torch.equal(got, torch.stack(want, 1).to(got.dtype))


# -- on the card (skip without one) ------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 and K3 have no CPU mode")


@pytest.mark.cuda
def test_card_prefill_launches_k2_and_k3():
    """One K2 launch an RG-LRU layer (2 n_super + rem) and one K3 launch
    an attention layer (n_super) in the prefill, none in decode."""
    _card()
    _, w, tm, _ = _pair(n_layers=5)
    p = params_from_numpy(w, device="cuda")
    toks = torch.tensor(_tokens(tm.cfg.vocab_size, S), device="cuda")
    k2, k3 = linear_scan_kernel.launches, flash_attention_kernel.launches
    _, cache = tm.prefill(p, {"tokens": toks})
    assert (linear_scan_kernel.launches - k2,
            flash_attention_kernel.launches - k3) == (3, 1)
    tm.decode_step(p, cache, toks[:, :1],
                   torch.full((B,), S, dtype=torch.int32, device="cuda"))
    assert (linear_scan_kernel.launches - k2,
            flash_attention_kernel.launches - k3) == (3, 1)


@pytest.mark.cuda
def test_card_matches_cpu():
    """Prefill and STEPS teacher-forced steps (the ring wrapping), the
    card against the CPU, fp32 (TF32 off)."""
    _card()
    _, w, tm, p = _pair()
    pc = params_from_numpy(w, device="cuda")
    toks = _tokens(tm.cfg.vocab_size, S + STEPS)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for params, dev in ((p, "cpu"), (pc, "cuda")):
            t = torch.tensor(toks, device=dev)
            lg, cache = tm.prefill(params, {"tokens": t[:, :S]},
                                   max_len=S + STEPS)
            got = [lg.cpu()]
            for i in range(STEPS):
                lg, cache = tm.decode_step(
                    params, cache, t[:, S + i:S + i + 1],
                    torch.full((B,), S + i, dtype=torch.int32, device=dev))
                got.append(lg.cpu())
            outs.append((got, tree_map(lambda x: x.cpu(), cache)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (want, wc), (got, gc) = outs
    for g, wl in zip(got, want):
        assert _rel(g, wl) < TOL
    _assert_cache(gc, tree_map(lambda x: x.numpy(), wc), TOL, "card")
