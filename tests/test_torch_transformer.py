"""The port's dense transformer serve path against the JAX package's.

TinyLlama-1.1B and Qwen2-0.5B (QKV bias, tied embeddings) at their
``reduced()`` size, from the JAX package's own weights
(``jax.tree.map(np.asarray, jmodel.init(PRNGKey(s)))`` through
``params_from_numpy``) and numpy tokens.  The JAX side runs both with its
XLA attention (``LOCAL``) and with its Pallas flash kernel in interpret
mode; the port runs on the CPU, where attention takes K3's plain
version.  Checked: ``predict`` logits, ``prefill`` logits and cache,
``decode_step`` logits and the committed cache, the sliding-window
variant's circular cache, the port's own prefill-then-decode
consistency, and ``serve`` against the JAX serve loop.

Tolerance: max abs error per unit of the reference's largest magnitude,
``TOL`` = 5e-4 for logits and caches.  The measured figure is below
4e-5 (logits) and 1.5e-5 (caches): the frameworks sum the fp32 products
and softmaxes in different orders.  The JAX package's own
prefill-vs-forward bound is 5e-3 (``tests/test_decode_consistency.py``);
the port's self-consistency checks keep that.

The bf16 serve path is held the same way: the JAX package's fp32 numpy
weights, cast to bf16 on each side (round to nearest even in both),
prefilled by both in bf16 (``BF16_TOL``, see there).
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
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen2-0.5b"]
IMPLS = ["xla", "pallas_interpret"]
B, S = 2, 24
TOL = 5e-4
CONSISTENCY_TOL = 5e-3
# bf16 prefill, port vs JAX: per unit of the reference's largest
# magnitude.  Both round every activation to bf16, but not at the same
# places (the frameworks fuse and accumulate differently), and the logits
# and caches are bf16 themselves: one bf16 ulp of x is 2^-8 to 2^-7 of
# |x|.  The bound allows ~3-5 ulps of the largest value; the measured
# figure on reduced TinyLlama is one ulp (4.9e-3 logits, 5.3e-3 caches),
# against ~4e-2 between the bf16 and the fp32 prefill of either package.
BF16_TOL = 2e-2


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-6)


def _pair(arch, impl="xla", seed=0, **over):
    """(JAX model, numpy weights, port model, port CPU weights)."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    jm = jax_build_model(jcfg, dataclasses.replace(LOCAL,
                                                   attention_impl=impl))
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, w, build_model(tcfg), params_from_numpy(w, device="cpu")


def _tokens(vocab, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, n)).astype(np.int32)


def _assert_cache(got_kv, want_kv, tag):
    for name in ("k", "v"):
        err = _rel(got_kv[name], want_kv[name])
        assert err < TOL, f"{tag}: cache {name} differs by {err}"
    np.testing.assert_array_equal(got_kv["pos"].numpy(),
                                  np.asarray(want_kv["pos"]))


@pytest.fixture(scope="module", params=[(a, i) for a in ARCHS
                                        for i in IMPLS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """One JAX run per (arch, attention impl): predict, prefill, one
    decode step, all jitted, on the same tokens the port gets."""
    arch, impl = request.param
    jm, w, tm, p = _pair(arch, impl)
    toks = _tokens(jm.cfg.vocab_size, S + 1)
    prompt = {"tokens": jnp.asarray(toks[:, :S])}
    logits = jax.jit(jm.predict)(w, prompt)
    pre_logits, cache = jax.jit(
        lambda w, b: jm.prefill(w, b, max_len=S + 4))(w, prompt)
    idx = np.full((B,), S, np.int32)
    dec_logits, cache2 = jax.jit(jm.decode_step)(
        w, cache, jnp.asarray(toks[:, S:]), jnp.asarray(idx))
    return dict(tm=tm, p=p, toks=toks, idx=idx, logits=logits,
                pre_logits=pre_logits, cache=cache, dec_logits=dec_logits,
                cache2=cache2)


def test_predict_matches_jax(run):
    got = run["tm"].predict(run["p"], {"tokens": torch.tensor(
        run["toks"][:, :S])})
    assert _rel(got, run["logits"]) < TOL


def test_prefill_matches_jax(run):
    logits, cache = run["tm"].prefill(
        run["p"], {"tokens": torch.tensor(run["toks"][:, :S])},
        max_len=S + 4)
    assert _rel(logits, run["pre_logits"]) < TOL
    _assert_cache(cache["kv"], run["cache"]["kv"], "prefill")


def test_decode_step_matches_jax(run):
    tm, p = run["tm"], run["p"]
    _, cache = tm.prefill(p, {"tokens": torch.tensor(run["toks"][:, :S])},
                          max_len=S + 4)
    logits, cache2 = tm.decode_step(p, cache,
                                    torch.tensor(run["toks"][:, S:]),
                                    torch.tensor(run["idx"]))
    assert cache2 is cache  # committed in place
    assert _rel(logits, run["dec_logits"]) < TOL
    _assert_cache(cache2["kv"], run["cache2"]["kv"], "decode")


@pytest.mark.parametrize("impl", IMPLS)
def test_sliding_window_circular_cache_matches_jax(impl):
    """Window 16 under a 24-token prompt: the prefill packs the last 16
    positions into their circular slots; 3 decode steps overwrite the
    oldest slots."""
    window, steps = 16, 3
    jm, w, tm, p = _pair("tinyllama-1.1b", impl, sliding_window=window)
    toks = _tokens(jm.cfg.vocab_size, S + steps)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + steps))(
        w, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S])},
                        max_len=S + steps)
    assert tc["kv"]["k"].shape[2] == window
    assert _rel(tl, jl) < TOL
    _assert_cache(tc["kv"], jc["kv"], "prefill")
    jdec = jax.jit(jm.decode_step)
    for i in range(steps):
        tok, idx = toks[:, S + i:S + i + 1], np.full((B,), S + i, np.int32)
        jl, jc = jdec(w, jc, jnp.asarray(tok), jnp.asarray(idx))
        tl, tc = tm.decode_step(p, tc, torch.tensor(tok), torch.tensor(idx))
        assert _rel(tl, jl) < TOL, f"step {i}"
        _assert_cache(tc["kv"], jc["kv"], f"step {i}")


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_prefill_matches_jax(impl):
    """Reduced TinyLlama served in bf16 (``Model.init(..., dtype=
    torch.bfloat16)`` on the card): the port's bf16 prefill logits and
    KV cache against the JAX package's bf16 prefill (XLA attention and
    the Pallas kernel in interpret mode), from the same fp32 numpy
    weights cast to bf16 on each side and numpy tokens."""
    from repro_torch.common.pytree import tree_map

    jm, w, tm, p = _pair("tinyllama-1.1b", impl)
    wj = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), w)
    pt = tree_map(lambda t: t.to(torch.bfloat16), p)
    toks = _tokens(jm.cfg.vocab_size, S, seed=6)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 4))(
        wj, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(pt, {"tokens": torch.tensor(toks)}, max_len=S + 4)
    assert jl.dtype == jnp.bfloat16 and tl.dtype == torch.bfloat16
    assert tc["kv"]["k"].dtype == torch.bfloat16 == tc["kv"]["v"].dtype

    def rel(got, want):
        return _rel(got.to(torch.float32),
                    np.asarray(want.astype(jnp.float32)))

    assert rel(tl, jl) < BF16_TOL
    for name in ("k", "v"):
        assert rel(tc["kv"][name], jc["kv"][name]) < BF16_TOL, name
    np.testing.assert_array_equal(tc["kv"]["pos"].numpy(),
                                  np.asarray(jc["kv"]["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The port's own teacher-forcing consistency, as
    tests/test_decode_consistency.py holds the JAX package's: prefill on
    S - 1 tokens and one decode step reproduce the forward's logits at
    positions S - 2 and S - 1, and 4 greedy steps each equal a fresh
    forward over the grown sequence."""
    _, _, tm, p = _pair(arch)
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


def test_sliding_window_within_window_equals_full_attention():
    _, _, tm, p = _pair("tinyllama-1.1b")
    tm_swa = build_model(dataclasses.replace(tm.cfg, sliding_window=64))
    batch = make_batch(tm.cfg, B, S, seed=4, device="cpu")
    assert float((tm.predict(p, batch) - tm_swa.predict(p, batch)).abs()
                 .max()) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_serve_loop(arch):
    """serve(device="cpu"), greedy, against the loop of
    repro/launch/serve.py on the same weights and prompt: the same tokens,
    and each step's logits under teacher forcing with the JAX tokens."""
    gen = 4
    jm, w, tm, p = _pair(arch)
    prompt = _tokens(jm.cfg.vocab_size, S, seed=2)
    max_len = S + gen
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=max_len))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(w, {"tokens": jnp.asarray(prompt)})
    jlogits = [logits]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)[:, 0]]
    for i in range(gen):
        idx = jnp.full((B,), S + i, jnp.int32)
        logits, cache = decode(w, cache, tok, idx)
        jlogits.append(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok)[:, 0])
    jtokens = np.stack(out, 1)

    before = flash_attention_kernel.launches
    got, stats = serve(tm, p, torch.tensor(prompt), gen, device="cpu")
    assert flash_attention_kernel.launches == before
    assert stats["k3_launches"] == 0 and stats["finite_logits"]
    np.testing.assert_array_equal(got.numpy(), jtokens)

    tl, tc = tm.prefill(p, {"tokens": torch.tensor(prompt)}, max_len=max_len)
    assert _rel(tl, jlogits[0]) < TOL
    for i in range(gen):
        tl, tc = tm.decode_step(
            p, tc, torch.tensor(jtokens[:, i:i + 1]),
            torch.full((B,), S + i, dtype=torch.int32))
        assert _rel(tl, jlogits[i + 1]) < TOL, f"step {i}"


def test_serve_samples_from_the_given_generator():
    _, _, tm, p = _pair("tinyllama-1.1b")
    prompt = make_batch(tm.cfg, B, 8, seed=5, device="cpu")["tokens"]

    def sample(seed):
        return serve(tm, p, prompt, 6, temperature=1.0, device="cpu",
                     generator=torch.Generator().manual_seed(seed))[0]

    a, b = sample(7), sample(7)
    assert torch.equal(a, b) and a.shape == (B, 7)
    assert int(a.min()) >= 0 and int(a.max()) < tm.cfg.vocab_size
    with pytest.raises(ValueError, match="generator"):
        serve(tm, p, prompt, 2, temperature=1.0, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "qkv_bias",
              "norm", "act", "tie_embeddings", "rope_theta",
              "sliding_window")
    for j, t in ((jax_get_arch(arch), get_arch(arch)),
                 (jax_get_arch(arch).reduced(), get_arch(arch).reduced()),
                 (jax_get_arch(arch).with_sliding_window(256).reduced(),
                  get_arch(arch).with_sliding_window(256).reduced())):
        assert {f: getattr(t, f) for f in fields} == \
            {f: getattr(j, f) for f in fields}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_spec(arch):
    """The port's init draws every leaf of the JAX tree with its shape and
    rule: fan_in std 1/sqrt(shape[-2]), ones for norms, zeros for
    biases, N(0, 0.02) for the embedding."""
    jm, w, tm, _ = _pair(arch)
    got = tm.init(torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    flat_t = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            flat_t[path] = node
        else:
            for k, v in node.items():
                walk(v, path + (k,))

    walk(got, ())
    assert len(flat_t) == len(flat_j)
    for path, arr in flat_j:
        t = flat_t[tuple(k.key for k in path)]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.float32
    wq = got["blocks"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[-2]) - 1.0) < 0.05
    assert float(got["embed"]["table"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(got["final_norm"]["scale"],
                       torch.ones_like(got["final_norm"]["scale"]))


def test_params_from_numpy_carries_nested_trees_as_copies():
    _, w, _, p = _pair("qwen2-0.5b")
    assert p["blocks"]["attn"]["bq"].shape == w["blocks"]["attn"]["bq"].shape
    p["blocks"]["attn"]["wq"].add_(1.0)
    assert not np.allclose(p["blocks"]["attn"]["wq"].numpy(),
                           w["blocks"]["attn"]["wq"])


def test_unported_features_raise_by_name():
    """Cross-attention (``kv_override``) and M-RoPE positions on TinyLlama
    match the JAX ``gqa_forward``: a config without M-RoPE sections
    rotates by plain RoPE whatever ``mrope_pos`` says, and cross-attention
    rotates only q.  A family the JAX package lacks raises by name.  The
    transformer's training loss, which raised until the training slice,
    runs and matches the JAX package's (tests/test_torch_train.py holds
    it and its gradients for every architecture)."""
    from repro.models import attention as jattn

    cfg = get_arch("tinyllama-1.1b").reduced()
    with pytest.raises(ValueError, match="nonesuch"):
        build_model(dataclasses.replace(cfg, family="nonesuch"))
    jm, w, tm, p = _pair("tinyllama-1.1b")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((2, 9, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    kpos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    mpos = np.broadcast_to(np.arange(6, dtype=np.int32)[::-1],
                           (3, 2, 6)).copy()
    ja = jax.tree.map(lambda a: jnp.asarray(a[0]), w["blocks"]["attn"])
    ta = {n: t[0] for n, t in p["blocks"]["attn"].items()}
    for kw in ({"kv_override": (k, 2 * k, kpos), "causal": False},
               {"mrope_pos": mpos}):
        want = jattn.gqa_forward(ja, jnp.asarray(x), jm.cfg, LOCAL, **{
            n: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for n, v in kw.items()})
        got = attn.gqa_forward(ta, torch.tensor(x), cfg, **{
            n: (tuple(map(torch.tensor, v)) if isinstance(v, tuple)
                else torch.tensor(v) if isinstance(v, np.ndarray) else v)
            for n, v in kw.items()})
        assert _rel(got, want) < TOL, sorted(kw)
    assert torch.equal(
        attn.gqa_forward(ta, torch.tensor(x), cfg,
                         mrope_pos=torch.tensor(mpos)),
        attn.gqa_forward(ta, torch.tensor(x), cfg))
    b = make_batch(cfg, 1, 4, device="cpu")
    want, _ = jm.loss(w, {n: jnp.asarray(v.numpy()) for n, v in b.items()})
    got, _ = tm.loss(p, b)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_layers_match_jax():
    """The layer library, including the pieces the dense configs do not
    reach (LayerNorm, the GELU MLP), against repro.models.layers."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    norm = {"scale": rng.standard_normal(32).astype(np.float32),
            "bias": rng.standard_normal(32).astype(np.float32)}
    tn = {k: torch.tensor(v) for k, v in norm.items()}
    for kind in ("rmsnorm", "layernorm"):
        assert _rel(TL.apply_norm(kind, tn, torch.tensor(x)),
                    JL.apply_norm(kind, norm, jnp.asarray(x))) < 1e-6
    for act in ("swiglu", "gelu"):
        w = {"w_gate": rng.standard_normal((32, 48)) / 6,
             "w_up": rng.standard_normal((32, 48)) / 6,
             "b_up": rng.standard_normal(48),
             "w_down": rng.standard_normal((48, 32)) / 7,
             "b_down": rng.standard_normal(32)}
        w = {k: v.astype(np.float32) for k, v in w.items()}
        if act == "gelu":
            del w["w_gate"]
        else:
            del w["b_up"], w["b_down"]
        got = TL.mlp({k: torch.tensor(v) for k, v in w.items()},
                     torch.tensor(x), act)
        assert _rel(got, JL.mlp(w, jnp.asarray(x), act)) < 1e-5, act
    q = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(1000 + np.arange(5, dtype=np.int32), (2, 5))
    assert _rel(TL.rope(torch.tensor(q), torch.tensor(pos.copy()), 1e4),
                JL.rope(jnp.asarray(q), jnp.asarray(pos), 1e4)) < 1e-5


def test_gqa_decode_immediate_write_matches_jax():
    """gqa_decode with the cache written before attending
    (defer_write=False) against the JAX one, and equal to the deferred
    path's attention."""
    from repro.models import attention as jattn

    jm, w, tm, p = _pair("qwen2-0.5b")
    cfg = tm.cfg
    rng = np.random.default_rng(8)
    slots = 12
    cache = {"k": rng.standard_normal((B, slots, cfg.n_kv_heads,
                                       cfg.head_dim)).astype(np.float32),
             "v": rng.standard_normal((B, slots, cfg.n_kv_heads,
                                       cfg.head_dim)).astype(np.float32),
             "pos": np.where(np.arange(slots) < 7, np.arange(slots),
                             2 ** 31 - 1).astype(np.int32)[None].repeat(B, 0)}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    idx = np.array([7, 7], np.int32)
    wa = jax.tree.map(lambda a: a[0], w["blocks"]["attn"])
    pa = {k: v[0] for k, v in p["blocks"]["attn"].items()}
    jy, jc = jattn.gqa_decode(wa, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, cache),
                              jnp.asarray(idx), jm.cfg, LOCAL)
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    ty, tc = attn.gqa_decode(pa, torch.tensor(x), tcache,
                             torch.tensor(idx), cfg)
    assert _rel(ty, jy) < TOL
    _assert_cache(tc, jc, "immediate write")
    assert torch.equal(tcache["k"], torch.tensor(cache["k"]))  # untouched
    ty2, _ = attn.gqa_decode(pa, torch.tensor(x), tcache, torch.tensor(idx),
                             cfg, defer_write=True)
    assert _rel(ty2, ty) < 1e-5
