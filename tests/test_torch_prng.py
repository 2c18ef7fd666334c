"""The port's copy of the JAX PRNG (``repro_torch.common.prng``) against
``jax.random`` itself.

Keys, 32-bit bits, uniforms and permutations must equal JAX's bit for
bit (threefry-2x32 with ``jax_threefry_partitionable``, JAX's default);
normals go through torch's ``erfinv``, not XLA's ``erf_inv``, and are
held within 1e-5 relative (about 5e-6 was seen on 200,000 draws).  The
chaos layer's two keyed draws, the upload codec's ``random_mask`` key
(``repro.sim.compile``'s ``fold_in(fold_in(PRNGKey(seed), t), cid)``)
and the corruption key, are pinned the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.algorithms import common as jax_common  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core.algorithms import common  # noqa: E402

NORMAL_RTOL = 1e-5
SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, -7]


def _jkey(key):
    """A JAX key's two words as int64."""
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bitwise(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _jkey(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 5, 104729, 2 ** 31 - 1])
def test_fold_in_bitwise(data):
    for seed in (0, 3):
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(seed), data).numpy(),
            _jkey(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_fold_in_batched_over_rows_bitwise():
    keys = torch.stack([prng.prng_key(s) for s in range(6)])
    data = torch.tensor([3, 0, 17, 2 ** 20, 9, 1])
    got = prng.fold_in(keys, data).numpy()
    for s in range(6):
        np.testing.assert_array_equal(got[s], _jkey(jax.random.fold_in(
            jax.random.PRNGKey(s), int(data[s]))))


@pytest.mark.parametrize("num", [2, 5])
def test_split_bitwise(num):
    np.testing.assert_array_equal(
        prng.split(prng.prng_key(3), num).numpy(),
        _jkey(jax.random.split(jax.random.PRNGKey(3), num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (1000,), (8, 256)])
def test_bits_and_uniform_bitwise(shape):
    key, tkey = jax.random.PRNGKey(11), prng.prng_key(11)
    np.testing.assert_array_equal(
        prng.random_bits(tkey, shape).numpy(),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))
    u = prng.uniform(tkey, shape).numpy()
    assert u.shape == shape
    np.testing.assert_array_equal(
        u.view(np.int32),
        np.asarray(jax.random.uniform(key, shape)).view(np.int32))
    # normal's range [nextafter(-1, 0), 1)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    np.testing.assert_array_equal(
        prng.uniform(tkey, shape, lo, 1.0).numpy().view(np.int32),
        np.asarray(jax.random.uniform(key, shape, minval=lo,
                                      maxval=1.0)).view(np.int32))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (200000,)])
def test_normal_within_tolerance(shape):
    key, tkey = jax.random.PRNGKey(5), prng.prng_key(5)
    np.testing.assert_allclose(prng.normal(tkey, shape).numpy(),
                               np.asarray(jax.random.normal(key, shape)),
                               rtol=NORMAL_RTOL, atol=0.0)


# 1625 is the largest n with one sort round, 1626 the smallest with two;
# 18,753 is the paper LSTM's parameter count at hidden 64
@pytest.mark.parametrize("n,rounds", [(1, 0), (7, 1), (1625, 1),
                                      (1626, 2), (18753, 2)])
def test_permutation_bitwise(n, rounds):
    assert prng.permutation_rounds(n) == rounds
    for seed in (0, 9):
        np.testing.assert_array_equal(
            prng.permutation(prng.prng_key(seed), n).numpy(),
            np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))


def test_permutation_batched_over_rows_bitwise():
    keys = prng.fold_in(torch.stack([prng.prng_key(s) for s in range(4)]),
                        torch.tensor([3, 4, 5, 6]))
    got = prng.permutation(keys, 1626).numpy()
    for s in range(4):
        np.testing.assert_array_equal(got[s], np.asarray(
            jax.random.permutation(
                jax.random.fold_in(jax.random.PRNGKey(s), 3 + s), 1626)))


def test_chaos_keys_bitwise():
    """The random_mask key of the JAX tick and the corruption key, per
    slot, from (seed, arrival stamp, client id)."""
    t = np.array([0, 3, 17, 511], np.float32)
    cid = np.array([4, 0, 255, 9], np.int32)
    for seed in (0, 42):
        key0 = prng.prng_key(seed)
        up = common.upload_keys(key0, torch.tensor(t), torch.tensor(cid))
        co = common.corruption_key(key0, torch.tensor(t), torch.tensor(cid))
        for s in range(len(t)):
            want = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed), jnp.int32(t[s])), jnp.int32(cid[s]))
            np.testing.assert_array_equal(up[s].numpy(), _jkey(want))
            np.testing.assert_array_equal(
                co[s].numpy(),
                _jkey(jax_common.corruption_key(seed, t[s], cid[s])))
