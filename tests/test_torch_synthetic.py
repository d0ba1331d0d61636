"""The port's synthetic data (``repro_torch.data.synthetic``) against the
reference's ``repro.data.synthetic``: TokenStream batches and spike trains
bit for bit from the same seed, and the uniform's range arguments against
``jax.random.uniform``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.core import rng
from repro_torch.data import synthetic as syn


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_stream_bitwise_at_full_vocab(seed):
    """smollm-360m's vocab (49,152), where the Zipf tail reaches deep into
    the ranks: every token equals the reference's over 4 steps of 8 x 512."""
    ours, theirs = syn.TokenStream(49152, 512, 8, seed), jsyn.TokenStream(49152, 512, 8, seed)
    for step in range(4):
        a = ours.batch(step)["tokens"].numpy()
        b = np.asarray(theirs.batch(step)["tokens"])
        np.testing.assert_array_equal(a, b)


def test_token_stream_reduced_vocab_and_host_slice():
    ours, theirs = syn.TokenStream(512, 64, 4, 1), jsyn.TokenStream(512, 64, 4, 1)
    for step in (0, 5, 123):
        np.testing.assert_array_equal(ours.batch(step)["tokens"].numpy(),
                                      np.asarray(theirs.batch(step)["tokens"]))
    sl = slice(1, 3)
    np.testing.assert_array_equal(ours.batch(2, host_slice=sl)["tokens"].numpy(),
                                  np.asarray(theirs.batch(2, host_slice=sl)["tokens"]))
    assert ours.batch(0)["tokens"].dtype == torch.int64


def test_xla_powf_matches_xla_power():
    """The Zipf power: XLA CPU's f32 power is the C library's powf; the
    port's ``xla_powf`` equals it on 200,000 inputs over [1e-6, 1)."""
    r = np.random.default_rng(0)
    u = np.exp(r.uniform(np.log(1e-6), 0.0, 200_000)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: x ** (-1.0 / (1.2 - 1.0)))(u))
    ours = syn.xla_powf(torch.from_numpy(u), -1.0 / (1.2 - 1.0)).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(1e-6, 1.0), (-2.0, 3.5), (0.0, 1.0)])
def test_uniform_range_bitwise(lo, hi):
    key = rng.fold_in(rng.key(3), 11)
    ours = rng.uniform(key, (64, 512), minval=lo, maxval=hi).numpy()
    jkey = jax.random.fold_in(jax.random.key(3), 11)
    ref = np.asarray(jax.jit(lambda k: jax.random.uniform(
        k, (64, 512), jnp.float32, minval=lo, maxval=hi))(jkey))
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("rate", [5.0, 40.0, 900.0])
def test_spike_train_bitwise(rate):
    ours = syn.spike_train(rng.key(9), 64, 200, rate).numpy()
    ref = np.asarray(jsyn.spike_train(jax.random.key(9), 64, 200, rate))
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.bool_
