"""Whisper-small (audio encoder-decoder, cross-attention) in the port
against the JAX package.

At the ``reduced()`` size (d_model 256, 4 heads over 2 KV heads, head
dim 64, d_ff 512, vocab 512, 2 encoder and 2 decoder layers, 16 stub
frames), from the JAX package's own weights (``jax.tree.map(np.asarray,
jmodel.init(...))`` through ``params_from_numpy``) and numpy inputs (the
port's ``make_batch`` draws, handed to both).  The JAX side runs under
both of its attention settings, ``attention_impl="xla"`` and
``"pallas_interpret"`` (the K3 Pallas kernel in interpret mode; its
cross-attention takes ``blocked_attention`` under both); the port runs
on the CPU, where K3 takes its plain version.

Every case but ``test_as_drawn_weights_match_jax`` scales every
attention's ``wq`` and ``wk`` (the encoder's, the decoder's self and
cross) of those weights by ``COOL`` = 1/8 on both sides.  As drawn,
the JAX spec's ``fan_in`` of a (d, heads, hd) projection is its head
count, so q and k entries have a standard
deviation of 8 to 11 and attention scores of ~90: every row is near
one-hot, and a near-tied row turns the frameworks' 1e-7 sum-order
differences into 1e-3 (fp32) or 0.37 (bf16) downstream.  Over 3 weight
seeds x 3 input draws (S = 24, 4 decode steps) the JAX package's own
fp32 lies up to 1.7e-3 from a run of the port with fp64 weights and
inputs, and its two attention settings up to 5.3e-4 from each other.
Cooled, the scores are O(1), as a trained model's are, and the same
comparisons measure below 5e-6 (fp32) and 6.8e-3 (bf16) per unit, where
a fault (a missing bias, a wrong sinusoid, a dropped layer) shows at
1e-2 to 1.  The weights as drawn are still held, fp32, in
``test_as_drawn_weights_match_jax`` at ``RAW_TOL`` = 2e-3 (measured up
to 1.5e-3 over the 9 draws).

Tolerances, per unit of the reference's largest magnitude: fp32 ``TOL``
= 5e-4, as ``tests/test_torch_hybrid.py``; bf16 at
``tests/test_torch_dense_configs.py``'s bounds (0.15 for logits, 4e-2
for caches) on eight draws, with bf16 frames on both sides (see
``test_bf16_matches_jax``).  Positions are equal exactly.
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
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.launch.serve import family_kernels, serve  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

ARCH = "whisper-small"
IMPLS = ["xla", "pallas_interpret"]
B, S = 2, 24
STEPS = 4
TOL = 5e-4
RAW_TOL = 2e-3
COOL = 0.125
CONSISTENCY_TOL = 5e-3
BF16_TOL = {"logits": 0.15, "cache": 4e-2}
DRAWS = (6, 0, 1, 2, 3, 4, 5, 7)


def _cfgs(**kw):
    """(JAX config, port config): reduced, with ``kw`` replaced."""
    return tuple(dataclasses.replace(get(ARCH).reduced(), **kw)
                 for get in (jax_get_arch, get_arch))


def _pair(impl="xla", seed=0, cool=True, **kw):
    """(JAX model, numpy weights, port model, port CPU weights); with
    ``cool`` every attention's wq and wk scaled by COOL."""
    jcfg, tcfg = _cfgs(**kw)
    jm = jax_build_model(jcfg, dataclasses.replace(LOCAL,
                                                   attention_impl=impl))
    w = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if cool:
        for blocks, names in (("enc_blocks", ("attn",)),
                              ("dec_blocks", ("self", "cross"))):
            for name in names:
                for leaf in ("wq", "wk"):
                    w[blocks][name][leaf] = w[blocks][name][leaf] * COOL
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


def _batch(cfg, n, seed=1, dtype=torch.float32):
    """(port batch, JAX batch) of ``n`` tokens and the stub frames: the
    port's ``make_batch`` draws, the same values on both sides."""
    b = make_batch(cfg, B, n, seed=seed, device="cpu", dtype=dtype)
    jb = {"tokens": jnp.asarray(b["tokens"].numpy()),
          "frames": jnp.asarray(b["frames"].to(torch.float32).numpy())}
    if dtype == torch.bfloat16:
        jb["frames"] = jb["frames"].astype(jnp.bfloat16)
    return b, jb


def _prompt(b, n=S):
    return {"tokens": b["tokens"][:, :n], "frames": b["frames"]}


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                       f"{prefix}/{k}")]


def _assert_cache(got, want, tag, tol=TOL):
    """Every leaf of the audio cache: ``pos`` equal, the rest within
    ``tol`` per unit."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], tag
    for (path, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == tuple(wl.shape), f"{tag} {path}"
        if path.endswith("pos"):
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl),
                                          err_msg=f"{tag} {path}")
            continue
        err = _rel(gl, wl)
        assert err < tol, f"{tag}: {path} differs by {err}"


def _dec_layer(w, p, i):
    """Decoder layer ``i``'s parameters: (JAX arrays, port tensors)."""
    return (jax.tree.map(lambda a: jnp.asarray(a[i]), w["dec_blocks"]),
            layer(p["dec_blocks"], i))


@pytest.fixture(scope="module", params=IMPLS)
def run(request):
    """One JAX run per attention setting: predict, prefill and STEPS
    teacher-forced decode steps, all jitted, on the inputs the port
    gets."""
    jm, w, tm, p = _pair(request.param)
    b, jb = _batch(tm.cfg, S + STEPS)
    prompt = {"tokens": jb["tokens"][:, :S], "frames": jb["frames"]}
    logits = jax.jit(jm.predict)(w, prompt)
    pre_logits, cache = jax.jit(
        lambda w, b: jm.prefill(w, b, max_len=S + STEPS))(w, prompt)
    decode = jax.jit(jm.decode_step)
    steps, c = [], cache
    for i in range(STEPS):
        lg, c = decode(w, c, jb["tokens"][:, S + i:S + i + 1],
                       jnp.full((B,), S + i, jnp.int32))
        steps.append((lg, c))
    return dict(tm=tm, p=p, b=b, logits=logits, pre_logits=pre_logits,
                cache=cache, steps=steps)


# -- config, spec and cache --------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_jax(size):
    """Every field of the port's config equals the JAX config's, at full
    size and at ``reduced()`` (2 encoder layers, 16 frames, G = 2)."""
    t, j = get_arch(ARCH), jax_get_arch(ARCH)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.family == "audio" and t.is_encoder_decoder
    assert (t.norm, t.act, t.qkv_bias) == ("layernorm", "gelu", True)
    want = {"full": (12, 12, 768, 12, 12, 64, 1536, 51865, 448),
            "reduced": (2, 2, 256, 4, 2, 64, 16, 512, 448)}[size]
    assert (t.n_layers, t.encoder_layers, t.d_model, t.n_heads,
            t.n_kv_heads, t.head_dim, t.encoder_frames, t.vocab_size,
            t.max_decode_len) == want


def test_params_cross_leaf_for_leaf():
    """The port's spec has every leaf of the JAX tree (``enc_blocks``,
    ``enc_norm``, ``dec_blocks`` with ``self`` / ``cross`` attention)
    with its shape, its init draws them, and ``params_from_numpy``
    carries the JAX weights across under the same paths."""
    jm, w, tm, p = _pair()
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    drawn = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert len(flat_j) == len(_leaves(p)) == len(_leaves(drawn))
    for path, arr in flat_j:
        t, d = p, drawn
        for k in path:
            t, d = t[k.key], d[k.key]
        np.testing.assert_array_equal(t.numpy(), arr)
        assert tuple(d.shape) == arr.shape and d.dtype == torch.float32
    assert set(p) == {"embed", "final_norm", "lm_head", "enc_blocks",
                      "enc_norm", "dec_blocks"}
    assert set(p["dec_blocks"]) == {"ln1", "self", "lnx", "cross", "ln2",
                                    "mlp"}
    assert tuple(p["dec_blocks"]["cross"]["wk"].shape) == (2, 256, 2, 64)
    assert tuple(p["enc_blocks"]["attn"]["bq"].shape) == (2, 4, 64)
    assert tuple(p["enc_norm"]["bias"].shape) == (256,)


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    want = jdec.init_cache(jcfg, B, 24, jnp.float32)
    got = build_model(tcfg).init_cache(B, 24, torch.float32, device="cpu")
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w] == [
        "/cross_k", "/cross_v", "/self/k", "/self/pos", "/self/v"]
    for (path, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == wl.shape, path
        np.testing.assert_array_equal(_np(gl), _np(wl))


# -- the pieces --------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(24, 256), (128, 768), (1536, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_matches_jax(seq, d, dtype):
    """The sinusoidal positions at the reduced and the full widths (1536
    frames: the full encoder's), cast to fp32 and to bf16.  fp32 holds
    within ``seq`` x 2^-22 absolute, four ulps of the largest angle: the
    frameworks' exps of the frequencies may differ by an ulp, which an
    angle of up to ``seq`` radians carries into the sine (measured 1.2e-4
    at 1536 frames, both 1.1e-4 from an fp64 table)."""
    want = jtf._sinusoidal(seq, d, getattr(jnp, dtype))
    got = tf._sinusoidal(seq, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (seq,
                                                                       d)
    diff = np.abs(_np(got) - _np(want))
    assert float(diff.max()) <= (seq * 2 ** -22 if dtype == "float32"
                                 else 2 ** -7)
    np.testing.assert_array_equal(_np(got)[0, 1::2], 1.0)


@pytest.mark.parametrize("impl", IMPLS)
def test_whisper_encode_matches_jax(impl):
    """The encoder over the stub frames: the sinusoid, non-causal
    self-attention without RoPE (K3's plain version; JAX's flash kernel
    under ``pallas_interpret``), the GELU MLP, ``enc_norm``."""
    jm, w, tm, p = _pair(impl)
    b, jb = _batch(tm.cfg, S)
    want = jtf._whisper_encode(w, jm.cfg, jm.dist, jb["frames"])
    got = tf._whisper_encode(p, tm.cfg, b["frames"])
    assert tuple(got.shape) == (B, 16, 256)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("use_rope", [False, True])
def test_cross_attention_matches_jax(use_rope):
    """``gqa_forward`` with ``kv_override = (k, v, k_positions)``: only q
    is projected (with its bias), rotated only with ``use_rope`` (as the
    JAX code does for a config without M-RoPE sections), and attends
    over the given keys non-causally through ``blocked_attention``."""
    jm, w, tm, p = _pair()
    jp, tp = _dec_layer(w, p, 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, 256)).astype(np.float32)
    k = rng.standard_normal((B, 16, 2, 64)).astype(np.float32)
    v = rng.standard_normal((B, 16, 2, 64)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(16, dtype=np.int32), (B, 16)).copy()
    kw = dict(causal=False, use_rope=use_rope)
    want = jattn.gqa_forward(
        jp["cross"], jnp.asarray(x), jm.cfg, LOCAL,
        kv_override=(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos)),
        **kw)
    got = attn.gqa_forward(
        tp["cross"], torch.tensor(x), tm.cfg,
        kv_override=(torch.tensor(k), torch.tensor(v), torch.tensor(kpos)),
        **kw)
    assert _rel(got, want) < TOL
    _, kv = attn.gqa_forward(
        tp["cross"], torch.tensor(x), tm.cfg, return_kv=True,
        kv_override=(torch.tensor(k), torch.tensor(v), torch.tensor(kpos)),
        **kw)
    assert torch.equal(kv[0], torch.tensor(k)) and torch.equal(
        kv[2], torch.tensor(kpos))


# -- the model ---------------------------------------------------------------


def test_predict_matches_jax(run):
    got = run["tm"].predict(run["p"], _prompt(run["b"]))
    assert _rel(got, run["logits"]) < TOL


def test_prefill_matches_jax(run):
    """Last-token logits and the cache: the decoder's self K/V in S +
    STEPS slots (the last STEPS unwritten), every layer's cross K/V."""
    logits, cache = run["tm"].prefill(run["p"], _prompt(run["b"]),
                                      max_len=S + STEPS)
    assert _rel(logits, run["pre_logits"]) < TOL
    assert tuple(cache["cross_k"].shape) == (2, B, 16, 2, 64)
    _assert_cache(cache, run["cache"], "prefill")


def test_decode_steps_match_jax(run):
    """STEPS teacher-forced steps, each writing its self K/V into the
    cache it is given and leaving the cross K/V as they are."""
    tm, p, b = run["tm"], run["p"], run["b"]
    _, cache = tm.prefill(p, _prompt(b), max_len=S + STEPS)
    cross, pos = cache["cross_k"].clone(), cache["self"]["pos"]
    for i, (jl, jc) in enumerate(run["steps"]):
        logits, cache2 = tm.decode_step(
            p, cache, b["tokens"][:, S + i:S + i + 1],
            torch.full((B,), S + i, dtype=torch.int32))
        assert cache2 is cache and cache["self"]["pos"] is pos
        assert _rel(logits, jl) < TOL, f"step {i}"
        _assert_cache(cache, jc, f"step {i}")
    assert torch.equal(cache["cross_k"], cross)
    assert int(pos.max()) == S + STEPS - 1


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_at_max_len_matches_jax(impl):
    """A step at ``cur_index = max_len`` past a full self cache: its K/V
    wrap into slot 0 (position 0 is overwritten before the token attends,
    as JAX writes then attends) and its sinusoid row is clamped to the
    table's last (JAX's ``mode="clip"``); then one more step at max_len +
    1."""
    jm, w, tm, p = _pair(impl)
    b, jb = _batch(tm.cfg, S + 2, seed=4)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S))(
        w, {"tokens": jb["tokens"][:, :S], "frames": jb["frames"]})
    tl, tc = tm.prefill(p, _prompt(b), max_len=S)
    assert _rel(tl, jl) < TOL
    decode = jax.jit(jm.decode_step)
    for i in range(2):
        tok = b["tokens"][:, S + i:S + i + 1]
        jl, jc = decode(w, jc, jnp.asarray(tok.numpy()),
                        jnp.full((B,), S + i, jnp.int32))
        tl, tc = tm.decode_step(p, tc, tok,
                                torch.full((B,), S + i, dtype=torch.int32))
        assert _rel(tl, jl) < TOL, f"step at {S + i}"
        _assert_cache(tc, jc, f"step at {S + i}")
    assert tc["self"]["pos"][0, 0, :3].tolist() == [S, S + 1, 2]


@pytest.mark.parametrize("impl", IMPLS)
def test_as_drawn_weights_match_jax(impl):
    """The JAX package's weights as drawn (no COOL; near-one-hot
    attention, see the module docstring), fp32 at ``RAW_TOL``: prefill
    logits and cache, then STEPS decode steps."""
    jm, w, tm, p = _pair(impl, cool=False)
    b, jb = _batch(tm.cfg, S + STEPS)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + STEPS))(
        w, {"tokens": jb["tokens"][:, :S], "frames": jb["frames"]})
    tl, tc = tm.prefill(p, _prompt(b), max_len=S + STEPS)
    assert _rel(tl, jl) < RAW_TOL
    _assert_cache(tc, jc, "prefill", RAW_TOL)
    decode = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = b["tokens"][:, S + i:S + i + 1]
        jl, jc = decode(w, jc, jnp.asarray(tok.numpy()),
                        jnp.full((B,), S + i, jnp.int32))
        tl, tc = tm.decode_step(p, tc, tok,
                                torch.full((B,), S + i, dtype=torch.int32))
        assert _rel(tl, jl) < RAW_TOL, f"step {i}"
    _assert_cache(tc, jc, "decode", RAW_TOL)


def test_prefill_then_decode_matches_forward():
    """The port's own teacher-forcing consistency, as
    tests/test_decode_consistency.py holds the JAX package's: prefill on
    S - 1 tokens and one decode step reproduce the forward's logits at
    positions S - 2 and S - 1."""
    _, _, tm, p = _pair()
    b, _ = _batch(tm.cfg, S, seed=3)
    full = tm.predict(p, b)
    scale = float(full.abs().max())
    logits_p, cache = tm.prefill(p, _prompt(b, S - 1), max_len=S + 8)
    assert float((logits_p - full[:, S - 2]).abs().max()) / scale \
        < CONSISTENCY_TOL
    logits_d, _ = tm.decode_step(
        p, cache, b["tokens"][:, S - 1:],
        torch.full((B,), S - 1, dtype=torch.int32))
    assert float((logits_d - full[:, S - 1]).abs().max()) / scale \
        < CONSISTENCY_TOL


def test_bf16_matches_jax():
    """Served in bf16: the JAX package's fp32 numpy weights cast to bf16
    on each side and the frames drawn in bf16 on both (fp32 frames would
    make JAX promote the encoder and the cross K/V to fp32; the port
    takes the frames in the weights' dtype), prefill and one decode step
    on each of DRAWS' eight input draws, at ``BF16_TOL``."""
    jm, w, tm, p = _pair()
    wj = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), w)
    pt = tree_map(lambda t: t.to(torch.bfloat16), p)
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 1))
    decode = jax.jit(jm.decode_step)
    idx = np.full((B,), S, np.int32)
    for seed in DRAWS:
        b, jb = _batch(tm.cfg, S + 1, seed=seed, dtype=torch.bfloat16)
        jl, jc = prefill(wj, {"tokens": jb["tokens"][:, :S],
                              "frames": jb["frames"]})
        tl, tc = tm.prefill(pt, _prompt(b), max_len=S + 1)
        assert tl.dtype == tc["cross_k"].dtype == torch.bfloat16
        assert jc["cross_k"].dtype == jnp.bfloat16
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed}"
        _assert_cache(tc, jc, f"draw {seed} prefill", BF16_TOL["cache"])
        jl, jc = decode(wj, jc, jb["tokens"][:, S:], jnp.asarray(idx))
        tl, tc = tm.decode_step(pt, tc, b["tokens"][:, S:],
                                torch.tensor(idx))
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed} decode"
        _assert_cache(tc, jc, f"draw {seed} decode", BF16_TOL["cache"])


def test_frames_in_another_dtype_raise():
    """fp32 frames against bf16 weights: the JAX code promotes the
    encoder to fp32, the port raises by name (``serve`` casts the stubs
    to the weights' dtype)."""
    _, _, tm, p = _pair(cool=False)
    pt = tree_map(lambda t: t.to(torch.bfloat16), p)
    b, _ = _batch(tm.cfg, S)
    with pytest.raises(TypeError, match="weights' dtype"):
        tm.prefill(pt, _prompt(b))


def test_serve_on_cpu_launches_no_kernel():
    """serve(device="cpu") with the frames as ``stubs`` equals the port's
    own prefill and greedy decode, and counts no kernel launch on the
    CPU; the family's kernel on the card is K3."""
    gen = 3
    _, _, tm, p = _pair()
    b, _ = _batch(tm.cfg, S, seed=2)
    k3 = flash_attention_kernel.launches
    got, stats = serve(tm, p, b["tokens"], gen, stubs={
        "frames": b["frames"]}, device="cpu")
    assert flash_attention_kernel.launches == k3
    assert stats["k3_launches"] == stats["k3_decode_launches"] == 0
    assert stats["finite_logits"] and tuple(got.shape) == (B, gen + 1)
    logits, cache = tm.prefill(p, _prompt(b), max_len=S + gen)
    want = [torch.argmax(logits, -1)]
    for i in range(gen):
        logits, cache = tm.decode_step(
            p, cache, want[-1][:, None].to(torch.int32),
            torch.full((B,), S + i, dtype=torch.int32))
        want.append(torch.argmax(logits, -1))
    assert torch.equal(got, torch.stack(want, 1).to(got.dtype))
    assert family_kernels(tm.cfg) == ("flash_attention",)


# -- on the card (skip without one) ------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_k3_at_the_encoder_shape(dtype):
    """K3 non-causal at the full encoder's per-layer shape (12 heads over
    12 KV heads, G = 1, hd 64, 1536 frames; batch 2) against its plain
    version on the card."""
    _card()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    Bc, F, KV, hd = 2, 1536, 12, 64
    q = torch.randn((Bc, F, KV, 1, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((Bc, F, KV, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((Bc, F, KV, hd), generator=g, device="cuda").to(dt)
    pos = torch.arange(F, dtype=torch.int32, device="cuda").expand(Bc, F)
    got = flash_attention(q, k, v, q_positions=pos, k_positions=pos,
                          causal=False)
    want = flash_attention_ref(q[:, :, :, 0].permute(0, 2, 1, 3),
                               k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                               pos, pos, causal=False)
    want = want.permute(0, 2, 1, 3)[:, :, :, None]
    tol = 2e-5 if dt == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * max(
        1.0, float(want.float().abs().max()))


@pytest.mark.cuda
def test_card_serve_launches_and_matches_cpu():
    """serve on the card: K3 once an encoder and once a decoder layer of
    the prefill, never in decode; prefill and STEPS teacher-forced steps
    on the card against the CPU, fp32 (TF32 off)."""
    _card()
    _, w, tm, p = _pair()
    pc = params_from_numpy(w, device="cuda")
    b, _ = _batch(tm.cfg, S + STEPS)
    _, stats = serve(tm, pc, b["tokens"][:, :S].cuda(), 2,
                     stubs={"frames": b["frames"]}, device="cuda")
    assert (stats["k3_launches"], stats["k3_decode_launches"]) == (4, 0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for params, dev in ((p, "cpu"), (pc, "cuda")):
            bd = {k: t.to(dev) for k, t in b.items()}
            lg, cache = tm.prefill(params, _prompt(bd), max_len=S + STEPS)
            got = [lg.cpu()]
            for i in range(STEPS):
                lg, cache = tm.decode_step(
                    params, cache, bd["tokens"][:, S + i:S + i + 1],
                    torch.full((B,), S + i, dtype=torch.int32, device=dev))
                got.append(lg.cpu())
            outs.append((got, tree_map(lambda x: x.cpu(), cache)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (want, wc), (got, gc) = outs
    for g, wl in zip(got, want):
        assert _rel(g, wl) < TOL
    _assert_cache(gc, tree_map(lambda x: x.numpy(), wc), "card")
