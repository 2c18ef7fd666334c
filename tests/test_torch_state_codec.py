"""The port's state storage table, stacked-state codecs and int4 packing
against the JAX package's (``repro.common.dtypes``,
``repro.core.algorithms.common.ClientStateCodec``,
``repro.sim.state_pool.pack_int4``).

The codecs are elementwise casts, subtractions, divisions and roundings
of the same fp32 inputs, so encode and decode are held **bit for bit**
against JAX's (bf16 compared as 16-bit patterns); int4 packing is pure
numpy and bitwise too.  The quantized round trip is held to its
``scale / 2`` bound.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common import dtypes as jax_dtypes  # noqa: E402
from repro.core import client as jax_client  # noqa: E402
from repro.core.algorithms import get_strategy as jax_get_strategy  # noqa: E402
from repro.sim import state_pool as jax_pool  # noqa: E402
from repro.sim.engine import RunConfig as JaxRunConfig  # noqa: E402
from repro.sim.workloads import get_workload as jax_get_workload  # noqa: E402
from repro_torch.common import dtypes  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.core import client as client_lib  # noqa: E402
from repro_torch.core.algorithms import get_strategy  # noqa: E402
from repro_torch.core.algorithms.common import make_state_codec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sim import state_pool  # noqa: E402
from repro_torch.sim.engine import RunConfig  # noqa: E402
from repro_torch.sim.workloads import get_workload  # noqa: E402

CODEC_DTYPES = ("bf16", "fp16", "int8", "int4")


def _raised(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


# ---------------------------------------------------------------------------
# The storage table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jax_dtypes.STATE_DTYPES) + ["BF16"])
def test_state_storage_matches_jax(name):
    """Every accepted name (aliases, case) resolves to the same storage:
    canonical name, levels, pool bits, storage width and kind."""
    st, jst = (dtypes.resolve_state_storage(name),
               jax_dtypes.resolve_state_storage(name))
    assert (st.name, st.levels, st.pool_bits, st.quantized) == \
        (jst.name, jst.levels, jst.pool_bits, jst.quantized)
    jdt = np.dtype(jst.dtype)
    assert dtypes.bytes_of(st.dtype) == jdt.itemsize == \
        jax_dtypes.bytes_of(jst.dtype)
    assert st.dtype.is_floating_point == (jdt.kind == "f" or
                                          jst.name == "bf16")
    assert dtypes.resolve_state_dtype(name) == st.dtype
    assert sorted(dtypes.STATE_DTYPES) == sorted(jax_dtypes.STATE_DTYPES)


@pytest.mark.parametrize("fn", ["resolve_state_dtype",
                                "resolve_state_storage"])
@pytest.mark.parametrize("name", ["int3", "fp8"])
def test_unknown_state_dtype_raises_as_jax(fn, name):
    assert getattr(dtypes, fn)(None) is None
    assert _raised(lambda: getattr(dtypes, fn)(name)) == \
        _raised(lambda: getattr(jax_dtypes, fn)(name))


# ---------------------------------------------------------------------------
# int4 nibble packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 8, 33])
def test_pack_int4_bitwise_against_jax(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(-8, 8, size=(5, n)).astype(np.int8)
    packed = state_pool.pack_int4(codes)
    np.testing.assert_array_equal(packed, jax_pool.pack_int4(codes))
    assert packed.dtype == np.uint8 and packed.shape == (5, (n + 1) // 2)
    np.testing.assert_array_equal(state_pool.unpack_int4(packed, n), codes)
    np.testing.assert_array_equal(state_pool.unpack_int4(packed, n),
                                  jax_pool.unpack_int4(packed, n))


def test_bf16_leaf_round_trips_through_its_bit_patterns():
    """The pool holds bf16 as int16 patterns: 2 bytes an element, and
    the transfer back gives the same bits (NaN, inf, -0 and subnormals
    included)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(4, 33)).astype(np.float32) * 1e3)
    x[0, :5] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40,
                             -float("inf")])
    xb = x.to(torch.bfloat16)
    host = state_pool.leaf_to_host(xb)
    assert host.dtype == np.int16 and host.nbytes == 2 * xb.numel()
    # the same rounding as JAX's cast (a NaN's payload is the library's)
    jbits = np.asarray(jnp.asarray(x.numpy(), jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(host.reshape(-1)[1:],
                                  jbits.reshape(-1)[1:])
    back = state_pool.leaf_to_device(host, torch.bfloat16, "cpu")
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.view(torch.int16).numpy(), host)
    host[0, 0] = 0  # a copy, never an alias of the pool's staging
    assert back.view(torch.int16)[0, 0].item() != 0


# ---------------------------------------------------------------------------
# The strategies' codecs against JAX's, bit for bit
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    """A leaf as comparable numpy bits (bf16 as int16 patterns)."""
    if isinstance(x, torch.Tensor):
        return state_pool.leaf_to_host(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _state(alg, w0, rng, P=3):
    """A stacked state of P rows near w0 (numpy), with a few deltas past
    the quantizer's clip: {leaf path: array}, structure per strategy."""
    def near(scale):
        out = {}
        for k, v in w0.items():
            d = rng.normal(size=(P,) + v.shape).astype(np.float32) * scale
            d.reshape(-1)[:3] = [0.9, -2.5, 1e-9]  # saturate / tiny
            out[k] = (v[None] + d).astype(np.float32)
        return out

    def noise(scale):
        return {k: (rng.normal(size=(P,) + v.shape) * scale).astype(
            np.float32) for k, v in w0.items()}

    scal = lambda lo, hi: rng.uniform(lo, hi, P).astype(  # noqa: E731
        np.float32).round()
    if alg == "asofed":
        return dict(params=near(0.2), server_params=near(0.1),
                    h=noise(0.05), v=noise(0.3), delay_sum=scal(0, 900),
                    rounds=scal(0, 40), n_samples=scal(0, 300))
    return {"w": near(0.2), "version": scal(0, 1000)}


def _to_jax(alg, st):
    if alg == "asofed":
        return jax_client.ClientState(**{
            k: jax.tree.map(jnp.asarray, v) for k, v in st.items()})
    return jax.tree.map(jnp.asarray, st)


def _to_port(alg, st):
    if alg == "asofed":
        return client_lib.ClientState(**{
            k: (params_from_numpy(v, device="cpu") if isinstance(v, dict)
                else torch.tensor(v)) for k, v in st.items()})
    return {"w": params_from_numpy(st["w"], device="cpu"),
            "version": torch.tensor(st["version"])}


def _codecs(alg, state_dtype, hidden=6):
    jwl, wl = jax_get_workload("lstm_regression"), get_workload(
        "lstm_regression")
    jcm, jmodel = jwl.build(hidden=hidden)
    cm, model = wl.build(hidden=hidden)
    jw0 = jmodel.init(jax.random.PRNGKey(0))
    w0np = jax.tree.map(np.asarray, jw0)
    jcodec = jax_get_strategy(alg).state_codec(
        jmodel, JaxRunConfig(state_dtype=state_dtype), jw0)
    codec = get_strategy(alg).state_codec(
        model, RunConfig(state_dtype=state_dtype),
        params_from_numpy(w0np, device="cpu"))
    return jcodec, codec, w0np


@pytest.mark.parametrize("state_dtype", CODEC_DTYPES)
@pytest.mark.parametrize("alg", ["asofed", "fedasync", "fedbuff"])
def test_codec_encode_decode_bitwise_against_jax(alg, state_dtype):
    jcodec, codec, w0 = _codecs(alg, state_dtype)
    st = _state(alg, w0, np.random.default_rng(1))
    jenc = jcodec.encode(_to_jax(alg, st))
    enc = codec.encode(_to_port(alg, st))
    jleaves, leaves = jax.tree.leaves(jenc), tree_leaves(enc)
    assert len(jleaves) == len(leaves)
    storage = dtypes.resolve_state_storage(state_dtype)
    n_coded = 0
    for j, p in zip(jleaves, leaves):
        np.testing.assert_array_equal(_bits(p), _bits(j))
        n_coded += p.dtype == storage.dtype
    # every parameter-like leaf is coded, the control scalars are not
    assert n_coded == len(leaves) - (3 if alg == "asofed" else 1)
    if storage.quantized:
        assert max(int(p.abs().max()) for p in leaves
                   if p.dtype == torch.int8) == storage.levels
    # decode both from the same codes
    jdec = jax.tree.leaves(jcodec.decode(jenc))
    dec = tree_leaves(codec.decode(enc))
    for j, p in zip(jdec, dec):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # the control scalars pass through exactly
    scalars = (["delay_sum", "rounds", "n_samples"] if alg == "asofed"
               else ["version"])
    dec_t = codec.decode(enc)
    for k in scalars:
        got = getattr(dec_t, k) if alg == "asofed" else dec_t[k]
        np.testing.assert_array_equal(got.numpy(), st[k])


@pytest.mark.parametrize("alg", ["asofed", "fedasync", "fedbuff",
                                 "fedavg", "fedprox", "local", "global"])
def test_fp32_means_no_codec(alg):
    """fp32 (or None) is no codec at all — the engine then runs no extra
    op — and the strategies without one keep None whatever the dtype."""
    wl = get_workload("lstm_regression")
    _, model = wl.build(hidden=4)
    w0 = model.init(torch.Generator().manual_seed(0), device="cpu")
    for name in (None, "fp32", "float32"):
        assert get_strategy(alg).state_codec(
            model, RunConfig(state_dtype=name), w0) is None
    has = alg in ("asofed", "fedasync", "fedbuff")
    assert (get_strategy(alg).state_codec(
        model, RunConfig(state_dtype="int8"), w0) is not None) == has


def _toy_codec(state_dtype, qclip=0.5):
    cfg = dataclasses.replace(RunConfig(), state_dtype=state_dtype,
                              state_qclip=qclip)
    anchor = {"w": torch.full((9,), 0.25), "c": torch.zeros(())}
    return make_state_codec(cfg, anchor, {"w": True, "c": False}), anchor


@pytest.mark.parametrize("state_dtype", ["int8", "int4"])
def test_quantized_round_trip_within_half_a_step(state_dtype):
    codec, anchor = _toy_codec(state_dtype)
    levels = dtypes.resolve_state_storage(state_dtype).levels
    scale = 0.5 / levels
    rng = np.random.default_rng(3)
    x = {"w": anchor["w"] + torch.tensor(
        rng.uniform(-0.5, 0.5, 9).astype(np.float32)),
        "c": torch.tensor(1027.0)}
    enc = codec.encode(x)
    assert enc["w"].dtype == torch.int8
    assert int(enc["w"].abs().max()) <= levels
    dec = codec.decode(enc)
    np.testing.assert_allclose(dec["w"].numpy(), x["w"].numpy(),
                               atol=scale / 2 + 1e-7)
    assert enc["c"].dtype == torch.float32 and float(dec["c"]) == 1027.0
    # out-of-range deltas saturate at the clip edge, never wrap
    big = codec.decode(codec.encode({"w": anchor["w"] + 7.0,
                                     "c": torch.tensor(0.0)}))
    np.testing.assert_allclose(big["w"].numpy(), anchor["w"].numpy() + 0.5,
                               atol=1e-6)


@pytest.mark.parametrize("state_dtype", ["int8", "int4"])
def test_quantized_reencode_is_stable(state_dtype):
    """encode(decode(c)) == c bitwise: pool round trips are idempotent."""
    codec, anchor = _toy_codec(state_dtype)
    rng = np.random.default_rng(7)
    x = {"w": anchor["w"] + torch.tensor(
        rng.uniform(-2.0, 2.0, 9).astype(np.float32)),
        "c": torch.tensor(5.0)}
    enc = codec.encode(x)
    enc2 = codec.encode(codec.decode(enc))
    for a, b in zip(tree_leaves(enc), tree_leaves(enc2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("qclip", [0.0, -1.0])
def test_bad_qclip_raises_as_jax(qclip):
    import types

    from repro.core.algorithms.common import make_state_codec as jax_make

    janchor = {"w": jnp.zeros((3,)), "c": jnp.zeros(())}
    jcfg = types.SimpleNamespace(state_dtype="int8", state_qclip=qclip)
    want = _raised(lambda: jax_make(jcfg, janchor, {"w": True, "c": False}))
    assert "state_qclip" in want
    assert _raised(lambda: _toy_codec("int8", qclip)) == want


def test_codec_scale_tree_matches_jax():
    """The quantized codec's per-leaf scale equals JAX's fp32 scale."""
    jcodec, codec, _ = _codecs("asofed", "int4")
    js = jax.tree.leaves(jcodec.scale)
    ps = tree_leaves(codec.scale)
    assert len(js) == len(ps) and codec.levels == jcodec.levels == 7
    for j, p in zip(js, ps):
        assert p.dtype == torch.float32 and p.dim() == 0
        assert p.item() == float(np.float32(j))
    assert codec.mask.params["w_x"] is True
    assert codec.mask.rounds is False
