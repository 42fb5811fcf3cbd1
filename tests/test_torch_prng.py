"""`monocular_slam_tpu_torch.utils.prng` against `jax.random`: keys, splits,
fold-ins, bits, bernoulli and randint bit for bit, uniform exactly, normal
(float32) within 1e-6 (XLA's erf_inv and the numpy copy of its polynomial
may round the last bit differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monocular_slam_tpu_torch.utils import prng
from port_util import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 3, 19, 12345, 2**31 - 1]
SHAPES = [(), (1,), (7,), (3, 5), (4, 3, 5), (33,)]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, pk = _jkey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), pk)
    for num in (2, 3, 10, (2, 3)):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)), prng.split(pk, num))
    for data in (0, 7, 1005, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, data)),
                                      prng.fold_in(pk, data))
    # chained: split of a fold-in of a split
    j2 = jax.random.split(jax.random.fold_in(jax.random.split(jk)[1], 1001), 3)
    p2 = prng.split(prng.fold_in(prng.split(pk)[1], 1001), 3)
    np.testing.assert_array_equal(np.asarray(j2), p2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_random_bits(shape, width):
    for seed in SEEDS[:3]:
        a = np.asarray(jax.random.bits(_jkey(seed), shape, dtype=f"uint{width}"))
        b = prng.random_bits(prng.PRNGKey(seed), width, shape)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_exact(shape, dtype):
    for seed in SEEDS:
        for lo, hi in ((0.0, 1.0), (-2.0, 2.0), (3.0, 3.5)):
            a = np.asarray(jax.random.uniform(_jkey(seed), shape, dtype, lo, hi))
            b = prng.uniform(prng.PRNGKey(seed), shape, dtype, lo, hi)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_normal(seed):
    for shape in SHAPES + [(20000,)]:
        a = np.asarray(jax.random.normal(_jkey(seed), shape, np.float32))
        b = prng.normal(prng.PRNGKey(seed), shape)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_erfinv32_polynomial():
    """The float32 erf_inv of XLA, on a grid that reaches both branches and
    the end points."""
    x = np.concatenate([np.linspace(-1, 1, 20001, dtype=np.float32),
                        np.float32(1) - np.logspace(-7, -1, 50).astype(np.float32)])
    a = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    b = prng.erfinv32(x)
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(b), fin)
    np.testing.assert_allclose(b[fin], a[fin], rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bernoulli(shape, dtype):
    for seed in SEEDS:
        for p in (0.5, 0.1, 0.9):
            a = np.asarray(jax.random.bernoulli(_jkey(seed), jnp.asarray(p, dtype), shape))
            np.testing.assert_array_equal(a, prng.bernoulli(prng.PRNGKey(seed), p, shape, dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_randint(shape, dtype):
    for seed in SEEDS:
        for lo, hi in ((0, 256), (-7, 1000), (5, 6), (0, 2**31 - 1), (3, 3)):
            a = np.asarray(jax.random.randint(_jkey(seed), shape, lo, hi, dtype=dtype))
            b = prng.randint(prng.PRNGKey(seed), shape, lo, hi, dtype)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
