"""The port's threefry stream (``repro_torch.core.rng``) against
``jax.random`` bit for bit: key data, split, fold_in and uniform."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import rng  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 5, 2**32 - 1, 123456789]


def words(k: torch.Tensor) -> np.ndarray:
    """The port's int32 key words as the reference's uint32 key data."""
    assert k.dtype == torch.int32
    return k.numpy().view(np.uint32)


def jax_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data(seed):
    k = rng.key(seed)
    assert k.shape == (2,) and k.nbytes == 8
    np.testing.assert_array_equal(words(k), jax_words(jax.random.key(seed)))


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, n):
    got = words(rng.split(rng.key(seed), n))
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got, jax_words(jax.random.split(jax.random.key(seed), n)))


def test_split_of_split_keys():
    """Keys that come out of split, with both words far from zero."""
    tk, jk = rng.key(42), jax.random.key(42)
    for _ in range(4):
        tk, jk = rng.split(tk)[1], jax.random.split(jk)[1]
        np.testing.assert_array_equal(words(tk), jax_words(jk))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 + 3, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_fold_in(seed, data):
    np.testing.assert_array_equal(
        words(rng.fold_in(rng.key(seed), data)),
        jax_words(jax.random.fold_in(jax.random.key(seed), np.uint32(data))))


@pytest.mark.parametrize("shape", [(1000, 200), (7, 3), (0, 5), (1200,)])
@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_uniform(seed, shape):
    got = rng.uniform(rng.key(seed), shape)
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, dtype=jnp.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if got.numel():
        assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_uniform_from_split_key_as_run_draws():
    """The draw the reference's ``run`` makes: ``uniform(split(key)[0], (T, n_gen))``."""
    k_draw = rng.split(rng.key(42))[0]
    jk_draw = jax.random.split(jax.random.key(42))[0]
    np.testing.assert_array_equal(
        rng.uniform(k_draw, (250, 30)).numpy(),
        np.asarray(jax.random.uniform(jk_draw, (250, 30), dtype=jnp.float32)))


def test_threefry_known_answer():
    """Threefry-2x32 (20 rounds) test vector of the Random123 suite that
    JAX's own tests use: key and counter all ones."""
    ones = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    y1, y2 = rng.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, ones, ones)
    assert (int(y1), int(y2)) == (0x1CB996FC, 0xBB002BE7)
