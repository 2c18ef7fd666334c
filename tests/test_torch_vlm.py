"""Qwen2-VL-72B (the dense trunk with M-RoPE and a patch-embedding
prefix) in the port against the JAX package.

At the ``reduced()`` size (d_model 256, 4 heads over 2 KV heads, head
dim 64, d_ff 512, vocab 512, 2 layers, a 16-patch prefix on a 4 x 4
grid, M-RoPE sections re-derived as (0, 16, 16): the temporal section is
empty), from the JAX package's own weights (``jax.tree.map(np.asarray,
jmodel.init(...))`` through ``params_from_numpy``) and numpy inputs (the
port's ``make_batch`` draws of tokens and patches, handed to both).  The
prompt, 24 positions, is longer than the patch prefix: the JAX code
fails on a shorter one, and the port raises.  The JAX side runs under
``attention_impl="xla"`` and ``"pallas_interpret"`` (the K3 Pallas
kernel in interpret mode); the port runs on the CPU, where K3 takes its
plain version.

Tolerances, per unit of the reference's largest magnitude: fp32 ``TOL``
= 5e-4, as ``tests/test_torch_hybrid.py`` (measured below 1.5e-4);
M-RoPE alone within 1e-6; bf16 at
``tests/test_torch_dense_configs.py``'s bounds (0.15 for logits, 4e-2
for caches) on eight draws.  Positions are equal exactly.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.launch.serve import family_kernels, serve  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

ARCH = "qwen2-vl-72b"
IMPLS = ["xla", "pallas_interpret"]
B, S = 2, 24
STEPS = 4
TOL = 5e-4
MROPE_TOL = 1e-6
CONSISTENCY_TOL = 5e-3
BF16_TOL = {"logits": 0.15, "cache": 4e-2}
DRAWS = (6, 0, 1, 2, 3, 4, 5, 7)


def _cfgs(**kw):
    """(JAX config, port config): reduced, with ``kw`` replaced."""
    return tuple(dataclasses.replace(get(ARCH).reduced(), **kw)
                 for get in (jax_get_arch, get_arch))


def _pair(impl="xla", seed=0):
    """(JAX model, numpy weights, port model, port CPU weights)."""
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg, dataclasses.replace(LOCAL,
                                                   attention_impl=impl))
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


def _batch(cfg, n, seed=1):
    """(port batch, JAX batch): ``n`` tokens and the stub patches, the
    port's ``make_batch`` draws, the same values on both sides."""
    b = make_batch(cfg, B, n, seed=seed, device="cpu")
    return b, {k: jnp.asarray(t.numpy()) for k, t in b.items()}


def _prompt(b, n=S):
    return {"tokens": b["tokens"][:, :n], "patches": b["patches"]}


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                       f"{prefix}/{k}")]


def _assert_cache(got, want, tag, tol=TOL):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w] == [
        "/kv/k", "/kv/pos", "/kv/v"], tag
    for (path, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == tuple(wl.shape), f"{tag} {path}"
        if path.endswith("pos"):
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl),
                                          err_msg=f"{tag} {path}")
        else:
            err = _rel(gl, wl)
            assert err < tol, f"{tag}: {path} differs by {err}"


@pytest.fixture(scope="module", params=IMPLS)
def run(request):
    """One JAX run per attention setting: predict, prefill and STEPS
    teacher-forced decode steps, all jitted, on the inputs the port
    gets."""
    jm, w, tm, p = _pair(request.param)
    b, jb = _batch(tm.cfg, S + STEPS)
    prompt = {"tokens": jb["tokens"][:, :S], "patches": jb["patches"]}
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


# -- config and spec ---------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_jax(size):
    """Every field equal to the JAX config's; ``reduced()`` re-derives
    the sections for head dim 64 as (0, 16, 16)."""
    t, j = get_arch(ARCH), jax_get_arch(ARCH)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    want = {"full": (80, 8192, 64, 8, 128, 29568, 1024, (16, 24, 24)),
            "reduced": (2, 256, 4, 2, 64, 512, 16, (0, 16, 16))}[size]
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.head_dim,
            t.d_ff, t.n_patches, t.mrope_sections) == want
    assert t.family == "vlm" and t.qkv_bias and not t.tie_embeddings


def test_params_cross_leaf_for_leaf():
    """The vlm's spec is the dense trunk's (``blocks`` stacked, QKV
    bias): every JAX leaf with its shape, drawn by the port's init,
    carried across by ``params_from_numpy``."""
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
    assert set(p) == {"embed", "final_norm", "lm_head", "blocks"}
    assert tuple(p["blocks"]["attn"]["bq"].shape) == (2, 4, 64)


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    want = jdec.init_cache(jcfg, B, 24, jnp.float32)
    got = build_model(tcfg).init_cache(B, 24, torch.float32, device="cpu")
    for (path, gl), (_, wl) in zip(_leaves(got), _leaves(want)):
        assert tuple(gl.shape) == wl.shape, path
        np.testing.assert_array_equal(_np(gl), _np(wl))


# -- M-RoPE and the patch prefix ---------------------------------------------


@pytest.mark.parametrize("hd,sections", [
    (64, (0, 16, 16)), (128, (16, 24, 24)), (64, (8, 12, 12)),
    (32, (16, 0, 0))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_jax(hd, sections, dtype):
    """M-RoPE over Qwen2-VL's layout (a 16-patch grid, then text), at the
    reduced sections (an empty temporal one), the full ones, and others;
    fp32 within MROPE_TOL per unit, bf16 one rounding of it."""
    P, Sx = 16, 40
    x = np.random.default_rng(hd + sum(sections)).standard_normal(
        (B, Sx, 3, hd)).astype(np.float32)
    pos = jlayers.mrope_positions(P, 4, Sx, B)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.mrope(jnp.asarray(x).astype(jdt), pos, sections, 1e6)
    got = layers.mrope(torch.tensor(x).to(tdt),
                       torch.tensor(np.asarray(pos)), sections, 1e6)
    assert got.dtype == tdt
    assert _rel(got, want) < (MROPE_TOL if dtype == "float32" else 2 ** -7)
    if sections[0] == 0:  # no temporal channel: image rows rotate by h, w
        assert not torch.equal(got[:, 1], torch.tensor(x).to(tdt)[:, 1])


def test_mrope_sections_must_cover_half_the_head_dim():
    x = torch.zeros((1, 4, 1, 64))
    pos = layers.mrope_positions(0, 1, 4, 1)
    with pytest.raises(ValueError, match="head_dim / 2"):
        layers.mrope(x, pos, (16, 24, 24), 1e6)


@pytest.mark.parametrize("P,grid,Sx,Bx", [(16, 4, 24, 2), (1024, 32, 2016, 1),
                                          (16, 4, 16, 3), (0, 1, 5, 1)])
def test_mrope_positions_match_jax(P, grid, Sx, Bx):
    want = np.asarray(jlayers.mrope_positions(P, grid, Sx, Bx))
    got = layers.mrope_positions(P, grid, Sx, Bx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_embed_inputs_match_jax():
    """The patch rows replace the first n_patches token rows (cast to the
    embedding's dtype), positions are arange and the (3, B, S) M-RoPE
    positions lay the patches on the 4 x 4 grid."""
    jm, w, tm, p = _pair()
    b, jb = _batch(tm.cfg, S)
    jx, jpos, jmpos = jtf._embed_inputs(w, jm.cfg, jb, jm.dist)
    x, pos, mpos = tf._embed_inputs(p, tm.cfg, b)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(mpos.numpy(), np.asarray(jmpos))
    assert torch.equal(x[:, :16], b["patches"])
    assert mpos[:, 0, 16:].tolist() == [list(range(1, 9))] * 3


def test_prompt_shorter_than_the_patch_prefix_raises():
    _, _, tm, p = _pair()
    b, _ = _batch(tm.cfg, 10)
    with pytest.raises(ValueError, match="16-patch prefix"):
        tm.prefill(p, _prompt(b, 10))


@pytest.mark.parametrize("impl", IMPLS)
def test_gqa_forward_with_mrope_matches_jax(impl):
    """Layer 0's attention with the M-RoPE positions: K3 masks by the
    arange positions while q and k rotate by ``mrope_pos``; the cache's
    k comes back rotated."""
    jm, w, tm, p = _pair(impl)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), w["blocks"]["attn"])
    tp = layer(p["blocks"]["attn"], 0)
    x = np.random.default_rng(5).standard_normal((B, S, 256)).astype(
        np.float32)
    mpos = jlayers.mrope_positions(16, 4, S, B)
    want, (jk, _, jkp) = jattn.gqa_forward(
        jp, jnp.asarray(x), jm.cfg, jm.dist, mrope_pos=mpos, return_kv=True)
    got, (k, _, kp) = attn.gqa_forward(
        tp, torch.tensor(x), tm.cfg, mrope_pos=torch.tensor(np.asarray(mpos)),
        return_kv=True)
    assert _rel(got, want) < TOL and _rel(k, jk) < TOL
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))


# -- the model ---------------------------------------------------------------


def test_predict_matches_jax(run):
    got = run["tm"].predict(run["p"], _prompt(run["b"]))
    assert _rel(got, run["logits"]) < TOL


def test_prefill_matches_jax(run):
    logits, cache = run["tm"].prefill(run["p"], _prompt(run["b"]),
                                      max_len=S + STEPS)
    assert _rel(logits, run["pre_logits"]) < TOL
    _assert_cache(cache, run["cache"], "prefill")


def test_decode_steps_match_jax(run):
    """STEPS teacher-forced steps, each rotated by M-RoPE at t = h = w =
    cur_index - n_patches + 1 and committed into the cache given."""
    tm, p, b = run["tm"], run["p"], run["b"]
    _, cache = tm.prefill(p, _prompt(b), max_len=S + STEPS)
    pos = cache["kv"]["pos"]
    for i, (jl, jc) in enumerate(run["steps"]):
        logits, cache2 = tm.decode_step(
            p, cache, b["tokens"][:, S + i:S + i + 1],
            torch.full((B,), S + i, dtype=torch.int32))
        assert cache2 is cache and cache["kv"]["pos"] is pos
        assert _rel(logits, jl) < TOL, f"step {i}"
        _assert_cache(cache, jc, f"step {i}")
    assert int(pos.max()) == S + STEPS - 1


def test_prefill_then_decode_matches_forward():
    """The port's own teacher-forcing consistency: prefill on S - 1
    positions and one decode step reproduce the forward's logits at
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
    on each side (the fp32 patches cast to bf16 by both), prefill and
    one decode step on each of DRAWS' eight draws, at ``BF16_TOL``."""
    jm, w, tm, p = _pair()
    wj = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), w)
    pt = tree_map(lambda t: t.to(torch.bfloat16), p)
    prefill = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 1))
    decode = jax.jit(jm.decode_step)
    idx = np.full((B,), S, np.int32)
    for seed in DRAWS:
        b, jb = _batch(tm.cfg, S + 1, seed=seed)
        jl, jc = prefill(wj, {"tokens": jb["tokens"][:, :S],
                              "patches": jb["patches"]})
        tl, tc = tm.prefill(pt, _prompt(b), max_len=S + 1)
        assert tl.dtype == tc["kv"]["k"].dtype == torch.bfloat16
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed}"
        _assert_cache(tc, jc, f"draw {seed} prefill", BF16_TOL["cache"])
        jl, jc = decode(wj, jc, jb["tokens"][:, S:], jnp.asarray(idx))
        tl, tc = tm.decode_step(pt, tc, b["tokens"][:, S:],
                                torch.tensor(idx))
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed} decode"
        _assert_cache(tc, jc, f"draw {seed} decode", BF16_TOL["cache"])


def test_serve_on_cpu_launches_no_kernel():
    """serve(device="cpu") with the patches as ``stubs`` equals the
    port's own prefill and greedy decode, and counts no kernel launch on
    the CPU; the family's kernel on the card is K3."""
    gen = 3
    _, _, tm, p = _pair()
    b, _ = _batch(tm.cfg, S, seed=2)
    k3 = flash_attention_kernel.launches
    got, stats = serve(tm, p, b["tokens"], gen,
                       stubs={"patches": b["patches"]}, device="cpu")
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
def test_card_serve_launches_and_matches_cpu():
    """serve on the card: K3 once a layer of the prefill, never in
    decode; prefill and STEPS teacher-forced steps on the card against
    the CPU, fp32 (TF32 off)."""
    _card()
    _, w, tm, p = _pair()
    pc = params_from_numpy(w, device="cuda")
    b, _ = _batch(tm.cfg, S + STEPS)
    _, stats = serve(tm, pc, b["tokens"][:, :S].cuda(), 2,
                     stubs={"patches": b["patches"]}, device="cuda")
    assert (stats["k3_launches"], stats["k3_decode_launches"]) == (2, 0)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_k3_with_mrope_rotated_inputs(dtype):
    """K3 on the M-RoPE-rotated q/k/v of the reduced model's layer 0 at
    head dim 128 (64 heads over 8 KV heads, Qwen2-VL's layout), causal,
    against its plain version on the card."""
    _card()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    Bc, Sc, KV, G, hd = 2, 300, 8, 8, 128
    mpos = layers.mrope_positions(256, 16, Sc, Bc, "cuda")
    q = torch.randn((Bc, Sc, KV * G, hd), generator=g, device="cuda")
    k = torch.randn((Bc, Sc, KV, hd), generator=g, device="cuda")
    v = torch.randn((Bc, Sc, KV, hd), generator=g, device="cuda").to(dt)
    q = layers.mrope(q, mpos, (16, 24, 24), 1e6).to(dt)
    k = layers.mrope(k, mpos, (16, 24, 24), 1e6).to(dt)
    pos = torch.arange(Sc, dtype=torch.int32, device="cuda").expand(Bc, Sc)
    got = flash_attention(q.reshape(Bc, Sc, KV, G, hd), k, v,
                          q_positions=pos, k_positions=pos, causal=True)
    want = flash_attention_ref(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        pos, pos, causal=True)
    want = want.permute(0, 2, 1, 3).reshape(Bc, Sc, KV, G, hd)
    tol = 2e-5 if dt == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * max(
        1.0, float(want.float().abs().max()))
