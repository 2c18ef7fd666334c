"""Falcon-Mamba-7B (Mamba-1 SSM) in the port against the JAX package.

At the ``reduced()`` size (2 layers, d_model 256, d_inner 512, state 16,
dt rank 16, vocab 512), from the JAX package's own weights
(``jax.tree.map(np.asarray, jmodel.init(PRNGKey(s)))`` through
``params_from_numpy``) and numpy inputs.  The JAX side runs under both of
its scan branches, ``scan_impl="xla"`` (``_fused_chunk_scan``) and
``scan_impl="pallas_interpret"`` (the K2 Pallas kernel in interpret
mode), set through ``dataclasses.replace(LOCAL, scan_impl=...)``; the
port runs on the CPU, where the selective scan takes the fused scan's
plain version.
Checked: each function of ``models/ssm.py`` and ``linear_scan_step``,
``predict``, ``prefill`` logits and the recurrent-state cache, four
teacher-forced decode steps, ``serve`` against the JAX serve loop, bf16,
the port's own prefill-then-decode consistency and constant-memory
decode, the config and the init spec.

Tolerances, per unit of the reference's largest magnitude: fp32
``TOL`` = 5e-4, as ``tests/test_torch_transformer.py``; the measured
figure is at most 2.7e-6 (prefill and decode logits) and 1.2e-6 (``h``,
``conv``) under either scan branch, from the frameworks' sum orders.
bf16 holds at ``tests/test_torch_dense_configs.py``'s bounds and method:
the same fp32 numpy weights cast to bf16 on each side, over
``len(DRAWS)`` token draws, 0.15 for logits and 4e-2 for the states;
the measured worst draw is 7.7e-3 (logits, one bf16 ulp) and 3.5e-3
(states).
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
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import (  # noqa: E402
    linear_scan_kernel, selective_scan_kernel)
from repro_torch.kernels.linear_scan.ref import fused_chunk  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.scan_utils import linear_scan_step  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

ARCH = "falcon-mamba-7b"
IMPLS = ["xla", "pallas_interpret"]
B, S = 2, 48
STEPS = 4
TOL = 5e-4
CONSISTENCY_TOL = 5e-3
BF16_TOL = {"logits": 0.15, "state": 4e-2}
DRAWS = (6, 0, 1, 2, 3, 4, 5, 7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-6)


def _dist(impl):
    return dataclasses.replace(LOCAL, scan_impl=impl)


def _pair(impl="xla", seed=0):
    """(JAX model, numpy weights, port model, port CPU weights)."""
    jm = jax_build_model(jax_get_arch(ARCH).reduced(), _dist(impl))
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, w, build_model(get_arch(ARCH).reduced()), \
        params_from_numpy(w, device="cpu")


def _tokens(vocab, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, n)).astype(np.int32)


def _layer0(w, p):
    """Layer 0's mamba parameters: (JAX arrays, port tensors)."""
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), w["blocks"]["mamba"]),
            layer(p["blocks"], 0)["mamba"])


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_state(got, want, tol, tag):
    for name in ("h", "conv"):
        err = _rel(got[name], want[name])
        assert err < tol, f"{tag}: state {name} differs by {err}"


@pytest.fixture(scope="module", params=IMPLS)
def run(request):
    """One JAX run per scan branch: predict, prefill and STEPS
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


# -- config and init ---------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_jax(size):
    t, j = get_arch(ARCH), jax_get_arch(ARCH)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.d_inner == j.d_inner
    want = ((64, 4096, 8192, 256, 65024) if size == "full"
            else (2, 256, 512, 16, 512))
    assert (t.n_layers, t.d_model, t.d_inner, t.ssm_dt_rank,
            t.vocab_size) == want
    assert (t.family, t.ssm_state, t.ssm_conv, t.tie_embeddings) == (
        "ssm", 16, 4, True)


def test_init_spec_shapes_and_rules():
    """The port's init draws every leaf of the JAX tree with its shape
    and rule: ``uniform_scaled`` within U(-scale, scale) (b_dt 4, A_log
    1) and spread over it, fan_in std 1/sqrt(shape[-2]), D ones, conv_b
    zeros."""
    _, w, tm, _ = _pair()
    got = tm.init(torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    n = 0
    for path, arr in flat_j:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.float32
        n += 1
    assert n == len(jax.tree.leaves(got)) == 14
    m = got["blocks"]["mamba"]
    for name, scale in (("b_dt", 4.0), ("A_log", 1.0)):
        v = m[name]
        assert float(v.abs().max()) <= scale, name
        assert float(v.min()) < -0.9 * scale and float(v.max()) > 0.9 * scale
        assert abs(float(v.mean())) < 0.1 * scale
        # the JAX draw is the same rule
        ja = w["blocks"]["mamba"][name]
        assert np.abs(ja).max() <= scale and ja.min() < -0.9 * scale
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert torch.equal(m["conv_b"], torch.zeros_like(m["conv_b"]))
    wi = m["w_in_x"]
    assert abs(float(wi.std()) * np.sqrt(wi.shape[-2]) - 1.0) < 0.05
    # one seed, one generator device: the same weights drawn again
    again = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["blocks"]["mamba"]["A_log"], m["A_log"])
    bf = tm.init(torch.Generator().manual_seed(0), device="cpu",
                 dtype=torch.bfloat16)
    assert torch.equal(bf["blocks"]["mamba"]["b_dt"],
                       m["b_dt"].to(torch.bfloat16))


def test_params_cross_leaf_for_leaf():
    """``params_from_numpy`` carries the JAX tree across: every leaf under
    the same path, equal values, copies (not views)."""
    _, w, _, p = _pair()
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    assert len(flat_j) == len(jax.tree.leaves(p))
    for path, arr in flat_j:
        t = p
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), arr)
    p["blocks"]["mamba"]["A_log"].add_(1.0)
    assert not np.allclose(p["blocks"]["mamba"]["A_log"].numpy(),
                           w["blocks"]["mamba"]["A_log"])


# -- the block's functions ---------------------------------------------------


@pytest.mark.parametrize("with_prev", [False, True], ids=["zero_pad", "prev"])
def test_causal_conv_matches_jax(with_prev):
    _, w, tm, p = _pair()
    jp, tp = _layer0(w, p)
    di, K = tm.cfg.d_inner, tm.cfg.ssm_conv
    x = _normal((B, 7, di), 1)
    prev = _normal((B, K - 1, di), 2) if with_prev else None
    want = jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             None if prev is None else jnp.asarray(prev))
    got = ssm._causal_conv(torch.tensor(x), tp["conv_w"], tp["conv_b"],
                           None if prev is None else torch.tensor(prev))
    assert got.dtype == torch.float32
    assert _rel(got, want) < TOL


def test_ssm_coeffs_matches_jax():
    _, w, tm, p = _pair()
    jp, tp = _layer0(w, p)
    xh = _normal((B, 9, tm.cfg.d_inner), 3)
    jdA, jdBx, jC = jssm._ssm_coeffs(jp, jnp.asarray(xh))
    dA, dBx, C = ssm._ssm_coeffs(tp, torch.tensor(xh))
    assert dA.dtype == dBx.dtype == torch.float32
    assert tuple(dA.shape) == (B, 9, tm.cfg.d_inner, tm.cfg.ssm_state)
    for got, want in ((dA, jdA), (dBx, jdBx), (C, jC)):
        assert _rel(got, want) < TOL
    # dA = exp(dt A) with dt > 0, A < 0
    assert float(dA.min()) > 0.0 and float(dA.max()) < 1.0


@pytest.mark.parametrize("S", [9, 512])
def test_mamba_layer_keeps_only_the_chunk_carries_for_backward(S):
    """Under grad a Mamba layer's forward keeps no (B, S, d_inner, N)
    tensor for its backward (it kept three, dA, dt * B and the states h,
    on the K2 route; the checkpointed K2 route kept none but held them
    all again in its backward): the fused scan's autograd Function saves
    xh, dt, A, bc and exactly one (B, n_chunks, d_inner, N) tensor, the
    state before each chunk (one chunk of 9 steps; two of 256 at S =
    512), from which its backward recomputes one chunk at a time.
    ``_ssm_coeffs``, which decode still takes, gives the same values bit
    for bit with and without grad."""
    _, _, tm, p = _pair()
    tp = tree_map(lambda t: t.detach().requires_grad_(),
                  layer(p["blocks"], 0)["mamba"])
    x = torch.tensor(_normal((B, S, tm.cfg.d_model), 4))
    di, N = tm.cfg.d_inner, tm.cfg.ssm_state
    chunks = (B, S // fused_chunk(S), di, N)
    shapes, xh_saved = [], []

    def pack(t):
        shapes.append(tuple(t.shape))
        if tuple(t.shape) == (B, S, di):
            xh_saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ssm.mamba_forward(tp, x, tm.cfg)
    assert (B, S, di, N) not in shapes
    assert not [sh for sh in shapes if len(sh) == 4 and sh != chunks]
    assert shapes.count(chunks) == 1
    assert xh_saved
    xh = torch.tensor(_normal((B, 9, di), 3))
    with torch.no_grad():
        want = ssm._ssm_coeffs(tp, xh)
    got = ssm._ssm_coeffs(tp, xh.requires_grad_())
    assert got[1].requires_grad
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)


def test_linear_scan_step_matches_jax():
    a, b = _normal((B, 8, 4), 4), _normal((B, 8, 4), 5)
    h = _normal((B, 8, 4), 6)
    want = jscan.linear_scan_step(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(h))
    got = linear_scan_step(torch.tensor(a), torch.tensor(b), torch.tensor(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # in h's dtype, computed in fp32
    hb = torch.tensor(h).to(torch.bfloat16)
    got_b = linear_scan_step(torch.tensor(a), torch.tensor(b), hb)
    assert got_b.dtype == torch.bfloat16
    assert torch.equal(got_b, (torch.tensor(a) * hb.float()
                               + torch.tensor(b)).to(torch.bfloat16))


@pytest.mark.parametrize("impl", IMPLS)
def test_mamba_forward_with_state_matches_jax(impl):
    _, w, tm, p = _pair(impl)
    jp, tp = _layer0(w, p)
    x = _normal((B, S, tm.cfg.d_model), 7)
    jcfg = jax_get_arch(ARCH).reduced()
    want, jst = jssm.mamba_forward(jp, jnp.asarray(x), jcfg, _dist(impl),
                                   return_state=True)
    got, st = ssm.mamba_forward(tp, torch.tensor(x), tm.cfg,
                                return_state=True)
    assert _rel(got, want) < TOL
    assert st["h"].dtype == torch.float32
    assert tuple(st["conv"].shape) == (B, tm.cfg.ssm_conv - 1,
                                       tm.cfg.d_inner)
    _assert_state(st, jst, TOL, impl)
    # without the state: the same output
    assert torch.equal(ssm.mamba_forward(tp, torch.tensor(x), tm.cfg), got)


def test_mamba_decode_matches_jax():
    _, w, tm, p = _pair()
    jp, tp = _layer0(w, p)
    cfg = tm.cfg
    x = _normal((B, 1, cfg.d_model), 8)
    h = np.abs(_normal((B, cfg.d_inner, cfg.ssm_state), 9))
    conv = _normal((B, cfg.ssm_conv - 1, cfg.d_inner), 10)
    want, jst = jssm.mamba_decode(
        jp, jnp.asarray(x), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        jax_get_arch(ARCH).reduced(), LOCAL)
    state = {"h": torch.tensor(h), "conv": torch.tensor(conv)}
    got, st = ssm.mamba_decode(tp, torch.tensor(x), state, cfg)
    assert _rel(got, want) < TOL
    _assert_state(st, jst, TOL, "decode")
    # the given state is read, not written
    assert np.array_equal(state["h"].numpy(), h)
    zero = ssm.mamba_init_state(cfg, B, torch.float32, "cpu")
    jzero = jssm.mamba_init_state(jax_get_arch(ARCH).reduced(), B,
                                  jnp.float32)
    for name in ("h", "conv"):
        assert tuple(zero[name].shape) == jzero[name].shape
        assert not zero[name].any()


# -- the model ----------------------------------------------------------------


def test_predict_matches_jax(run):
    got = run["tm"].predict(run["p"], {"tokens": torch.tensor(
        run["toks"][:, :S])})
    assert _rel(got, run["logits"]) < TOL


def test_prefill_matches_jax(run):
    logits, cache = run["tm"].prefill(
        run["p"], {"tokens": torch.tensor(run["toks"][:, :S])},
        max_len=S + STEPS)
    assert _rel(logits, run["pre_logits"]) < TOL
    st, jst = cache["state"], run["cache"]["state"]
    assert st["h"].dtype == torch.float32 == st["conv"].dtype
    assert tuple(st["h"].shape) == jst["h"].shape
    assert tuple(st["conv"].shape) == jst["conv"].shape
    _assert_state(st, jst, TOL, "prefill")


def test_decode_steps_match_jax(run):
    """Four teacher-forced steps; each writes its state into the cache it
    is given."""
    tm, p, toks = run["tm"], run["p"], run["toks"]
    _, cache = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S])},
                          max_len=S + STEPS)
    h = cache["state"]["h"]
    for i, (jl, jc) in enumerate(run["steps"]):
        logits, cache2 = tm.decode_step(
            p, cache, torch.tensor(toks[:, S + i:S + i + 1]),
            torch.full((B,), S + i, dtype=torch.int32))
        assert cache2 is cache and cache["state"]["h"] is h  # in place
        assert _rel(logits, jl) < TOL, f"step {i}"
        _assert_state(cache["state"], jc["state"], TOL, f"step {i}")


def test_serve_matches_jax_serve_loop():
    """serve(device="cpu"), greedy, against the loop of
    repro/launch/serve.py on the same weights and prompt: the same
    tokens, and each step's logits under teacher forcing with the JAX
    tokens; no kernel launch on the CPU."""
    gen = 4
    jm, w, tm, p = _pair()
    prompt = _tokens(jm.cfg.vocab_size, S, seed=2)
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + gen))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(w, {"tokens": jnp.asarray(prompt)})
    jlogits = [logits]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)[:, 0]]
    for i in range(gen):
        logits, cache = decode(w, cache, tok, jnp.full((B,), S + i,
                                                       jnp.int32))
        jlogits.append(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok)[:, 0])
    jtokens = np.stack(out, 1)

    before = linear_scan_kernel.launches
    got, stats = serve(tm, p, torch.tensor(prompt), gen, device="cpu")
    assert linear_scan_kernel.launches == before
    assert stats["k2_launches"] == stats["k2_decode_launches"] == 0
    assert stats["k3_launches"] == 0 and stats["finite_logits"]
    np.testing.assert_array_equal(got.numpy(), jtokens)

    tl, tc = tm.prefill(p, {"tokens": torch.tensor(prompt)},
                        max_len=S + gen)
    assert _rel(tl, jlogits[0]) < TOL
    for i in range(gen):
        tl, tc = tm.decode_step(p, tc, torch.tensor(jtokens[:, i:i + 1]),
                                torch.full((B,), S + i, dtype=torch.int32))
        assert _rel(tl, jlogits[i + 1]) < TOL, f"step {i}"


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_prefill_and_decode_match_jax(impl):
    """Served in bf16: the JAX package's fp32 numpy weights cast to bf16
    on each side (round to nearest even in both), prefill and one decode
    step on each of DRAWS' token draws.  ``h`` stays fp32 and the conv
    window bf16 on both sides."""
    jm, w, tm, p = _pair(impl)
    wj = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), w)
    pt = tree_map(lambda t: t.to(torch.bfloat16), p)
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 1))
    decode = jax.jit(jm.decode_step)
    idx = np.full((B,), S, np.int32)
    for seed in DRAWS:
        toks = _tokens(jm.cfg.vocab_size, S + 1, seed=seed)
        jl, jc = prefill(wj, {"tokens": jnp.asarray(toks[:, :S])})
        tl, tc = tm.prefill(pt, {"tokens": torch.tensor(toks[:, :S])},
                            max_len=S + 1)
        assert tl.dtype == torch.bfloat16
        assert tc["state"]["h"].dtype == torch.float32
        assert tc["state"]["conv"].dtype == torch.bfloat16
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed}"
        _assert_state(tc["state"], jc["state"], BF16_TOL["state"],
                      f"draw {seed} prefill")
        jl, jc = decode(wj, jc, jnp.asarray(toks[:, S:]), jnp.asarray(idx))
        tl, tc = tm.decode_step(pt, tc, torch.tensor(toks[:, S:]),
                                torch.tensor(idx))
        assert torch.isfinite(tl.to(torch.float32)).all()
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed} decode"
        _assert_state(tc["state"], jc["state"], BF16_TOL["state"],
                      f"draw {seed} decode")


def test_prefill_then_decode_matches_forward():
    """The port's own teacher-forcing consistency, as
    tests/test_decode_consistency.py holds the JAX package's: prefill on
    S - 1 tokens and one decode step reproduce the forward's logits at
    positions S - 2 and S - 1, and 4 greedy steps each equal a fresh
    forward over the grown sequence."""
    _, _, tm, p = _pair()
    batch = make_batch(tm.cfg, B, S, seed=3, device="cpu")
    full = tm.predict(p, batch)
    scale = float(full.abs().max())
    logits_p, cache = tm.prefill(p, {"tokens": batch["tokens"][:, :S - 1]},
                                 max_len=S + 8)
    assert float((logits_p - full[:, S - 2]).abs().max()) / scale \
        < CONSISTENCY_TOL
    logits_d, cache = tm.decode_step(
        p, cache, batch["tokens"][:, S - 1:], torch.full((B,), S - 1,
                                                         dtype=torch.int32))
    assert float((logits_d - full[:, S - 1]).abs().max()) / scale \
        < CONSISTENCY_TOL
    seq = batch["tokens"]
    toks = torch.argmax(logits_d, -1, keepdim=True).to(torch.int32)
    for i in range(4):
        seq = torch.cat([seq, toks], dim=1)
        logits_d, cache = tm.decode_step(
            p, cache, toks, torch.full((B,), S + i, dtype=torch.int32))
        ref = tm.predict(p, {"tokens": seq})[:, -1]
        assert float((logits_d - ref).abs().max()) / float(
            ref.abs().max()) < CONSISTENCY_TOL, f"step {i}"
        toks = torch.argmax(logits_d, -1, keepdim=True).to(torch.int32)


def test_recurrent_state_long_decode_is_constant_memory():
    """As tests/test_long_context.py holds the JAX package: the SSM cache
    does not grow with ``max_len`` or with how far decode has gone."""
    _, _, tm, p = _pair()
    cache = tm.init_cache(B, max_len=10**6, dtype=torch.float32,
                          device="cpu")
    small = tm.init_cache(B, max_len=4, dtype=torch.float32, device="cpu")
    sizes = [t.numel() for t in cache["state"].values()]
    assert max(sizes) < 10**6
    assert {k: tuple(t.shape) for k, t in cache["state"].items()} == \
        {k: tuple(t.shape) for k, t in small["state"].items()}
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for i in [0, 1, 500_000]:
        logits, cache = tm.decode_step(p, cache, tok,
                                       torch.full((B,), i, dtype=torch.int32))
        assert torch.isfinite(logits).all()
        assert [t.numel() for t in cache["state"].values()] == sizes


def test_unported_families_still_raise_by_name():
    """vlm and audio build now (tests/test_torch_vlm.py,
    tests/test_torch_audio.py); only a family name the JAX package lacks
    raises, by name."""
    for arch in ("qwen2-vl-72b", "whisper-small"):
        cfg = get_arch(arch).reduced()
        assert build_model(cfg).cfg.family in ("vlm", "audio")
    with pytest.raises(ValueError, match="'mamba2'"):
        build_model(dataclasses.replace(get_arch(ARCH).reduced(),
                                        family="mamba2"))


# -- on the card (skip without one) ------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU mode")


@pytest.mark.cuda
def test_card_prefill_launches_k2_once_per_layer():
    """K2's redesign on this path, the fused selective scan, once a layer
    of the prefill; K2 itself no more; neither in decode."""
    _card()
    _, w, tm, _ = _pair()
    p = params_from_numpy(w, device="cuda")
    toks = torch.tensor(_tokens(tm.cfg.vocab_size, S), device="cuda")
    before = linear_scan_kernel.launches
    fused = selective_scan_kernel.launches
    _, cache = tm.prefill(p, {"tokens": toks})
    assert selective_scan_kernel.launches - fused == tm.cfg.n_layers
    tm.decode_step(p, cache, toks[:, :1],
                   torch.full((B,), S, dtype=torch.int32, device="cuda"))
    assert selective_scan_kernel.launches - fused == tm.cfg.n_layers
    assert linear_scan_kernel.launches == before


@pytest.mark.cuda
def test_card_matches_cpu():
    """Prefill and STEPS teacher-forced steps, the card against the CPU,
    fp32 (TF32 off)."""
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
            lg, cache = tm.prefill(params, {"tokens": t[:, :S]})
            got = [lg.cpu()]
            for i in range(STEPS):
                lg, cache = tm.decode_step(
                    params, cache, t[:, S + i:S + i + 1],
                    torch.full((B,), S + i, dtype=torch.int32, device=dev))
                got.append(lg.cpu())
            outs.append((got, {k: v.cpu() for k, v in
                               cache["state"].items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (want, wst), (got, gst) = outs
    for g, wl in zip(got, want):
        assert _rel(g, wl) < TOL
    _assert_state(gst, wst, TOL, "card")
