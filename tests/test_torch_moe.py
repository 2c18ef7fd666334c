"""The MoE family in the port against the JAX package: DeepSeek-V2-Lite
(MLA attention, 64 routed experts top-6 + 2 shared, one leading dense
layer) and Kimi-K2 (GQA at head dim 112, 384 routed experts top-8 + 1
shared, one leading dense layer).

At the ``reduced()`` size (d_model 256, 4 heads, 4 experts top-2, expert
d_ff 128, vocab 512, 2 layers: one dense and one MoE; MLA at latent rank
64, q/k head dims 32 + 16, v head dim 32), from the JAX package's own
weights (``jax.tree.map(np.asarray, jmodel.init(...))`` through
``params_from_numpy``) and numpy inputs.  The JAX side runs
``moe_dense`` (``LOCAL``: no mesh) and, for Kimi-K2, both of its
attention settings, ``attention_impl="xla"`` and ``"pallas_interpret"``
(the K3 Pallas kernel in interpret mode); the port runs on the CPU,
where K3 takes its plain version.  ``reduced()`` recomputes Kimi-K2's
head dim as d_model / n_heads = 64, so the head-dim-112 cases set
``head_dim=112`` on both packages' configs.

Tolerances, per unit of the reference's largest magnitude: the MoE
block's pieces in fp32 within 1e-5 and the router's gates within 1e-6
(the frameworks' sum orders differ at the 1e-7 level); the model within
``TOL`` = 5e-4, as ``tests/test_torch_ssm.py``; bf16 at
``tests/test_torch_dense_configs.py``'s bounds (0.15 for logits, 4e-2
for caches, on eight token draws).  Expert ids and positions are equal
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.launch.serve import family_kernels, serve  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import spec as spec_lib  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402

DEEPSEEK, KIMI = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
ARCHS = (DEEPSEEK, KIMI)
B, S = 2, 40
STEPS = 4
TOL = 5e-4
MOE_TOL = 1e-5
GATE_TOL = 1e-6
CONSISTENCY_TOL = 5e-3
BF16_TOL = {"logits": 0.15, "cache": 4e-2}
DRAWS = (6, 0, 1, 2, 3, 4, 5, 7)
# (arch, JAX attention setting) of the model-level runs: MLA never
# reaches K3, so DeepSeek runs once
RUNS = [(DEEPSEEK, "xla"), (KIMI, "xla"), (KIMI, "pallas_interpret")]


def _cfgs(arch, **kw):
    """(JAX config, port config): reduced, with ``kw`` replaced."""
    return tuple(dataclasses.replace(get(arch).reduced(), **kw)
                 for get in (jax_get_arch, get_arch))


def _pair(arch, impl="xla", seed=0, **kw):
    """(JAX model, numpy weights, port model, port CPU weights)."""
    jcfg, tcfg = _cfgs(arch, **kw)
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
    """Every leaf of the MoE cache: ``pos`` equal, the rest within ``tol``
    per unit."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], tag
    for (path, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == tuple(wl.shape), f"{tag} {path}"
        if path.endswith("pos"):
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl),
                                          err_msg=f"{tag} {path}")
        else:
            err = _rel(gl, wl)
            assert err < tol, f"{tag}: {path} differs by {err}"


def _moe_layer0(w, p):
    """The first MoE layer's parameters: (JAX arrays, port tensors)."""
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), w["moe_blocks"]),
            layer(p["moe_blocks"], 0))


@pytest.fixture(scope="module", params=RUNS, ids=[f"{a}-{i}" for a, i in RUNS])
def run(request):
    """One JAX run per (arch, attention setting): predict, prefill and
    STEPS teacher-forced decode steps, all jitted, on the tokens the port
    gets."""
    jm, w, tm, p = _pair(*request.param)
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


# -- configs, spec and weights -----------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, size):
    """Every field of the port's config equals the JAX config's, at full
    size and at ``reduced()`` (MLA keeps head_dim 0 in both)."""
    t, j = get_arch(arch), jax_get_arch(arch)
    if size == "reduced":
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.family == "moe" and t.first_dense_layers == 1
    assert j.q_lora_rank == 0  # the port has no q compression
    want = {(DEEPSEEK, "full"): (27, 2048, 16, 0, 64, 6, 2, 1408, True),
            (KIMI, "full"): (61, 7168, 64, 112, 384, 8, 1, 2048, False),
            (DEEPSEEK, "reduced"): (2, 256, 4, 0, 4, 2, 2, 128, True),
            (KIMI, "reduced"): (2, 256, 4, 64, 4, 2, 1, 128, False)}
    assert (t.n_layers, t.d_model, t.n_heads, t.head_dim, t.n_experts,
            t.top_k, t.n_shared_experts, t.d_ff_expert,
            t.use_mla) == want[(arch, size)]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_leaf_for_leaf(arch):
    """The port's spec has every leaf of the JAX tree (``dense_blocks``
    and ``moe_blocks`` stacked) with its shape, its init draws them, and
    ``params_from_numpy`` carries the JAX weights across under the same
    paths (copies, not views)."""
    jm, w, tm, p = _pair(arch)
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    drawn = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert len(flat_j) == len(_leaves(p)) == len(_leaves(drawn))
    for path, arr in flat_j:
        t, d = p, drawn
        for k in path:
            t, d = t[k.key], d[k.key]
        np.testing.assert_array_equal(t.numpy(), arr)
        assert tuple(d.shape) == arr.shape and d.dtype == torch.float32
    cfg = tm.cfg
    assert set(p) == {"embed", "final_norm", "lm_head", "dense_blocks",
                      "moe_blocks"}
    mb = p["moe_blocks"]
    assert tuple(mb["moe"]["w_gate"].shape) == (1, 4, 256, 128)
    assert tuple(mb["moe"]["router"].shape) == (1, 256, 4)
    assert tuple(mb["shared"]["w_up"].shape) == (
        1, 256, cfg.n_shared_experts * cfg.d_ff_expert)
    assert tuple(p["dense_blocks"]["mlp"]["w_up"].shape) == (1, 256, 512)
    if cfg.use_mla:
        assert tuple(mb["attn"]["wq"].shape) == (1, 256, 4, 48)
        assert tuple(mb["attn"]["w_dkv"].shape) == (1, 256, 64)
    mb["moe"]["w_gate"].add_(1.0)
    assert not np.allclose(mb["moe"]["w_gate"].numpy(),
                           w["moe_blocks"]["moe"]["w_gate"])


def test_large_leaves_are_drawn_one_matrix_at_a_time(monkeypatch):
    """A leaf past ``SLICE_DRAW_BYTES`` in fp32 is drawn matrix by matrix
    into its own dtype: the shape, the dtype and each matrix's fan-in
    scale hold, and one seed gives one draw."""
    monkeypatch.setattr(spec_lib, "SLICE_DRAW_BYTES", 1000)
    d = spec_lib.ParamDef((3, 4, 256, 64), init="fan_in")
    leaf = spec_lib.init_params({"w": d}, torch.Generator().manual_seed(0),
                                torch.bfloat16, device="cpu")["w"]
    assert tuple(leaf.shape) == d.shape and leaf.dtype == torch.bfloat16
    std = leaf.to(torch.float32).reshape(12, -1).std(-1)
    assert torch.allclose(std, torch.full_like(std, 1 / 16), rtol=0.1)
    again = spec_lib.init_params({"w": d}, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")["w"]
    assert torch.equal(leaf, again)
    assert not torch.equal(leaf[0, 0], leaf[0, 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jdec.init_cache(jcfg, B, 24, jnp.float32)
    got = build_model(tcfg).init_cache(B, 24, torch.float32, device="cpu")
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, gl), (_, wl) in zip(g, w):
        assert tuple(gl.shape) == wl.shape, path
        np.testing.assert_array_equal(_np(gl), _np(wl))


def test_family_is_ported_and_others_still_raise_by_name():
    """Every family of the JAX package builds (vlm and audio too); a
    family name the JAX package lacks raises by name."""
    for arch in ARCHS:
        assert build_model(get_arch(arch).reduced()).cfg.family == "moe"
    for arch, fam in (("qwen2-vl-72b", "vlm"), ("whisper-small", "audio")):
        assert build_model(get_arch(arch).reduced()).cfg.family == fam
    cfg = get_arch(KIMI).reduced()
    with pytest.raises(ValueError, match="'moe-v2'") as e:
        build_model(dataclasses.replace(cfg, family="moe-v2"))
    assert "moe, ssm" in str(e.value)
    assert family_kernels(get_arch(KIMI)) == ("flash_attention",)
    assert family_kernels(get_arch(DEEPSEEK)) == ()


# -- routing and the expert block --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(dtype):
    """64 experts top-6 (DeepSeek's routing width) on 96 tokens: the same
    expert ids in the same order, gates within 1e-6, the aux loss."""
    T, d, E, k = 96, 64, 64, 6
    x, wr = _normal((T, d), 1), _normal((d, E), 2) / 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jg, ji, jaux = jmoe._route(jnp.asarray(wr).astype(jdt),
                               jnp.asarray(x).astype(jdt), k)
    g, i, aux = moe._route(torch.tensor(wr).to(tdt),
                           torch.tensor(x).to(tdt), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert g.dtype == torch.float32
    assert float(np.max(np.abs(g.numpy() - np.asarray(jg)))) < GATE_TOL
    assert abs(float(aux) - float(jaux)) < GATE_TOL * float(jaux)


def test_route_breaks_ties_as_lax_top_k():
    """Planted ties at the k-th probability (equal router columns give
    bit-equal logits): the lower expert id wins, as ``lax.top_k`` puts
    it, and tied experts inside the top k come in ascending id."""
    E, k = 8, 2
    wr = np.zeros((E, E), np.float32)
    wr[np.arange(E), np.arange(E)] = 1.0
    rows = np.array([
        [3, 1, 1, 0, 0, 0, 0, 0],      # tie for slot 2: experts 1, 2
        [0, 2, 0.5, 2, 0, 0, 0, 0],    # tie inside the top 2: 1, 3
        [1, 1, 1, 0, 0, 0, 0, 1],      # four-way tie for both slots
        [0, 0, 0, 0, 0, 0, 5, 5],      # the last two experts
    ], np.float32)
    for dtype in ("float32", "bfloat16"):
        jg, ji, _ = jmoe._route(jnp.asarray(wr).astype(dtype),
                                jnp.asarray(rows).astype(dtype), k)
        g, i, _ = moe._route(torch.tensor(wr).to(getattr(torch, dtype)),
                             torch.tensor(rows).to(getattr(torch, dtype)),
                             k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(i.numpy(),
                                      [[0, 1], [1, 3], [0, 1], [6, 7]])
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GATE_TOL)


def test_expert_ffn_matches_jax():
    E, C, d, f = 3, 10, 32, 16
    buf = _normal((E, C, d), 3)
    ws = [_normal(s, 4 + n) / 4 for n, s in enumerate(
        [(E, d, f), (E, d, f), (E, f, d)])]
    want = jmoe._expert_ffn(jnp.asarray(buf), *map(jnp.asarray, ws))
    got = moe._expert_ffn(torch.tensor(buf), *map(torch.tensor, ws))
    assert _rel(got, want) < MOE_TOL


@pytest.mark.parametrize("products", ["_gathered", "_all_experts", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch, products, monkeypatch):
    """The routed experts of the first MoE layer on (B, S, d) inputs: the
    port's gathered and all-expert products (each forced), and the one
    ``_dispatch`` picks, against JAX's all-experts loop, fp32, within
    1e-5 per unit of max |y|; the aux loss alike."""
    jm, w, tm, p = _pair(arch)
    jp, tp = _moe_layer0(w, p)
    x = _normal((B, S, tm.cfg.d_model), 7)
    if products:
        fn = getattr(moe, products)
        monkeypatch.setattr(moe, "_dispatch", lambda n: fn)
    want, jaux = jmoe.moe_dense(jp["moe"], jnp.asarray(x), jm.cfg)
    got, aux = moe.moe_dense(tp["moe"], torch.tensor(x), tm.cfg)
    assert got.dtype == torch.float32
    assert _rel(got, want) < MOE_TOL
    assert abs(float(aux) - float(jaux)) < GATE_TOL * float(jaux)


def test_moe_dispatch_choice():
    """``_dispatch`` runs every expert at once on a call of up to
    ALL_EXPERTS_MAX_TOKENS tokens (a decode step, at any batch a card
    serves) and gathers beyond (a prefill); the two products give the
    same routed outputs."""
    _, _, tm, p = _pair(KIMI)
    tp, cfg = layer(p["moe_blocks"], 0)["moe"], tm.cfg
    n = moe.ALL_EXPERTS_MAX_TOKENS
    assert moe._dispatch(1) is moe._dispatch(n) is moe._all_experts
    assert moe._dispatch(n + 1) is moe._dispatch(8 * 2016) is moe._gathered
    xt = torch.tensor(_normal((5, cfg.d_model), 8))
    ids = torch.tensor([[0, 1], [1, 3], [2, 3], [0, 2], [1, 2]])
    torch.testing.assert_close(moe._gathered(tp, xt, ids),
                               moe._all_experts(tp, xt, ids),
                               rtol=0, atol=1e-6)


# -- attention: blocked and MLA ----------------------------------------------


@pytest.mark.parametrize("s_kv", [1, 7, 64, 100, 2016, 4096, 6000, 8192])
def test_pick_block_matches_jax(s_kv):
    for target in (64, 1024):
        assert attn._pick_block(s_kv, target) == jattn._pick_block(
            s_kv, target)


@pytest.mark.parametrize("causal,window,block", [
    (True, 0, 1024), (True, 0, 32), (True, 24, 32), (False, 0, 32)])
def test_blocked_attention_value_dim_matches_jax(causal, window, block):
    """Key dim 48, value dim 32 (MLA's shapes), GQA groups of 2, over one
    block and over several (``block_size`` 32 on 96 keys)."""
    Bq, Sq, KV, G, hd, vd = 2, 96, 3, 2, 48, 32
    q = _normal((Bq, Sq, KV, G, hd), 11)
    k = _normal((Bq, Sq, KV, hd), 12)
    v = _normal((Bq, Sq, KV, vd), 13)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (Bq, Sq)).copy()
    kw = dict(causal=causal, window=window, scale=0.2, block_size=block)
    want = jattn.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos), **kw)
    got = attn.blocked_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        q_positions=torch.tensor(pos), k_positions=torch.tensor(pos), **kw)
    assert tuple(got.shape) == (Bq, Sq, KV, G, vd)
    assert _rel(got, want) < MOE_TOL


def test_mla_forward_with_kv_matches_jax():
    """MLA's prefill attention on the first MoE layer: the output and the
    latent cache entries (c_kv, the rotated k_r, positions)."""
    jm, w, tm, p = _pair(DEEPSEEK)
    jp, tp = _moe_layer0(w, p)
    x = _normal((B, S, tm.cfg.d_model), 14)
    want, (jc, jkr, jpos) = jattn.mla_forward(
        jp["attn"], jnp.asarray(x), jm.cfg, LOCAL, return_kv=True)
    got, (c, kr, pos) = attn.mla_forward(tp["attn"], torch.tensor(x),
                                         tm.cfg, return_kv=True)
    assert _rel(got, want) < MOE_TOL
    assert tuple(c.shape) == (B, S, 64) and tuple(kr.shape) == (B, S, 16)
    assert _rel(c, jc) < MOE_TOL and _rel(kr, jkr) < MOE_TOL
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert torch.equal(attn.mla_forward(tp["attn"], torch.tensor(x),
                                        tm.cfg), got)


def test_mla_decode_matches_jax():
    """Weight-absorbed decode over a half-written latent cache: the
    output, and the new slot written into the cache given (in place)."""
    jm, w, tm, p = _pair(DEEPSEEK)
    jp, tp = _moe_layer0(w, p)
    cfg, slots = tm.cfg, 24
    cache = attn.mla_init_cache(cfg, B, slots, torch.float32, "cpu")
    cache["c_kv"][:, :10] = torch.tensor(_normal((B, 10, 64), 15))
    cache["k_r"][:, :10] = torch.tensor(_normal((B, 10, 16), 16))
    cache["pos"][:, :10] = torch.arange(10, dtype=torch.int32)
    jcache = {k: jnp.asarray(t.numpy()) for k, t in cache.items()}
    x = _normal((B, 1, cfg.d_model), 17)
    cur = np.array([10, 10], np.int32)
    want, jc = jattn.mla_decode(jp["attn"], jnp.asarray(x), jcache,
                                jnp.asarray(cur), jm.cfg, LOCAL)
    c_kv = cache["c_kv"]
    got, c = attn.mla_decode(tp["attn"], torch.tensor(x), cache,
                             torch.tensor(cur), cfg)
    assert c is cache and cache["c_kv"] is c_kv
    assert _rel(got, want) < MOE_TOL
    _assert_cache(c, jc, MOE_TOL, "mla decode")
    assert int(c["pos"][0, 10]) == 10


# -- the model ---------------------------------------------------------------


def test_predict_matches_jax(run):
    got = run["tm"].predict(run["p"], {"tokens": torch.tensor(
        run["toks"][:, :S])})
    assert _rel(got, run["logits"]) < TOL


def test_prefill_matches_jax(run, monkeypatch):
    """The prefill's logits and cache, under the products ``_dispatch``
    picks for its B S tokens (every expert at once at this size) and
    with the gathered rows forced (what a long prompt takes)."""
    for forced in (None, moe._gathered):
        if forced:
            monkeypatch.setattr(moe, "_dispatch", lambda n: forced)
        logits, cache = run["tm"].prefill(
            run["p"], {"tokens": torch.tensor(run["toks"][:, :S])},
            max_len=S + STEPS)
        assert _rel(logits, run["pre_logits"]) < TOL, forced
        _assert_cache(cache, run["cache"], TOL, f"prefill {forced}")


def test_decode_steps_match_jax(run):
    """STEPS teacher-forced steps, each writing its K/V (GQA: committed
    after the layer loop) or latent (MLA) into the cache it is given."""
    tm, p, toks = run["tm"], run["p"], run["toks"]
    _, cache = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S])},
                          max_len=S + STEPS)
    pos = cache["moe_kv"]["pos"]
    for i, (jl, jc) in enumerate(run["steps"]):
        logits, cache2 = tm.decode_step(
            p, cache, torch.tensor(toks[:, S + i:S + i + 1]),
            torch.full((B,), S + i, dtype=torch.int32))
        assert cache2 is cache and cache["moe_kv"]["pos"] is pos
        assert _rel(logits, jl) < TOL, f"step {i}"
        _assert_cache(cache, jc, TOL, f"step {i}")
    assert int(pos.max()) == S + STEPS - 1


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_kimi_head_dim_112_matches_jax(impl):
    """Kimi-K2's own head dim on the reduced config (``head_dim=112`` on
    both sides: 4 heads over 2 KV heads), prefill and two decode steps
    against JAX (its Pallas attention at hd 112 under
    ``pallas_interpret``)."""
    jm, w, tm, p = _pair(KIMI, impl, head_dim=112)
    assert tm.cfg.head_dim == jm.cfg.head_dim == 112
    toks = _tokens(jm.cfg.vocab_size, S + 2, seed=5)
    jl, jc = jax.jit(lambda w, b: jm.prefill(w, b, max_len=S + 2))(
        w, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tm.prefill(p, {"tokens": torch.tensor(toks[:, :S])},
                        max_len=S + 2)
    assert tuple(tc["dense_kv"]["k"].shape) == (1, B, S + 2, 2, 112)
    assert _rel(tl, jl) < TOL
    _assert_cache(tc, jc, TOL, "hd112 prefill")
    decode = jax.jit(jm.decode_step)
    for i in range(2):
        tok, idx = toks[:, S + i:S + i + 1], S + i
        jl, jc = decode(w, jc, jnp.asarray(tok), jnp.full((B,), idx,
                                                         jnp.int32))
        tl, tc = tm.decode_step(p, tc, torch.tensor(tok),
                                torch.full((B,), idx, dtype=torch.int32))
        assert _rel(tl, jl) < TOL, f"step {i}"
    _assert_cache(tc, jc, TOL, "hd112 decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_jax(arch):
    """Served in bf16: the JAX package's fp32 numpy weights cast to bf16
    on each side, prefill and one decode step on each of DRAWS' eight
    token draws, logits and every cache leaf at ``BF16_TOL``."""
    jm, w, tm, p = _pair(arch)
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
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed}"
        _assert_cache(tc, jc, BF16_TOL["cache"], f"draw {seed} prefill")
        jl, jc = decode(wj, jc, jnp.asarray(toks[:, S:]), jnp.asarray(idx))
        tl, tc = tm.decode_step(pt, tc, torch.tensor(toks[:, S:]),
                                torch.tensor(idx))
        assert _rel(tl, jl) < BF16_TOL["logits"], f"draw {seed} decode"
        _assert_cache(tc, jc, BF16_TOL["cache"], f"draw {seed} decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The port's own teacher-forcing consistency, as
    tests/test_decode_consistency.py holds the JAX package's: prefill on
    S - 1 tokens and one decode step reproduce the forward's logits at
    positions S - 2 and S - 1."""
    _, _, tm, p = _pair(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu_launches_no_kernel(arch):
    """serve(device="cpu") greedy equals the port's own prefill and greedy
    decode, and counts no kernel launch on the CPU."""
    gen = 3
    _, _, tm, p = _pair(arch)
    prompt = _tokens(tm.cfg.vocab_size, S, seed=2)
    k3 = flash_attention_kernel.launches
    got, stats = serve(tm, p, torch.tensor(prompt), gen, device="cpu")
    assert flash_attention_kernel.launches == k3
    assert stats["k3_launches"] == stats["k3_decode_launches"] == 0
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
        pytest.skip("needs a CUDA card: K3 has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_serve_launches(arch):
    """serve on the card: K3 once a layer of the prefill for GQA (Kimi,
    at head dim 112), never for MLA (DeepSeek), never in decode."""
    _card()
    kw = {"head_dim": 112} if arch == KIMI else {}
    _, w, tm, _ = _pair(arch, **kw)
    pc = params_from_numpy(w, device="cuda")
    prompt = torch.tensor(_tokens(tm.cfg.vocab_size, S), device="cuda")
    _, stats = serve(tm, pc, prompt, 2, device="cuda")
    want = 0 if arch == DEEPSEEK else tm.cfg.n_layers
    assert (stats["k3_launches"], stats["k3_decode_launches"]) == (want, 0)
    assert stats["finite_logits"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu(arch):
    """Prefill and STEPS teacher-forced steps, the card against the CPU,
    fp32 (TF32 off), Kimi at head dim 112."""
    _card()
    kw = {"head_dim": 112} if arch == KIMI else {}
    _, w, tm, p = _pair(arch, **kw)
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
