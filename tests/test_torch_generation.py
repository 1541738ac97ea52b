"""The port's generation utilities (``text/generation.py``) against the
JAX package's, on the CPU.

The filters and the greedy choice are held exactly equal to the
reference's on the same numpy logits (ties included: both take the first
maximum). Sampling draws from a ``torch.Generator`` where the reference
takes a JAX key, so it is held in distribution only: the same generator
state gives the same tokens, every token lies in the filtered support,
and over 20000 draws each token's frequency is within 0.02 of the
filtered softmax's probability (the reference's filters, computed by
JAX). One frequency's standard error is at most sqrt(0.25 / 20000) =
0.0035, so the bound is over 5.6 of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.text import generation as ref

from paddle_tpu_torch.text import generation as port


def _logits(seed=0, b=4, v=97):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, v) * 3).astype(np.float32)
    x[1, 5] = x[1, 40] = x[1].max() + 1.0      # a tie for the maximum
    x[2, :] = 0.5                              # a row of equal logits
    return x


@pytest.mark.parametrize("k", [None, 0, 1, 5, 96, 97, 200])
def test_top_k_logits_equals_reference(k):
    x = _logits(1)
    want = np.asarray(ref.top_k_logits(jnp.asarray(x), k))
    got = port.top_k_logits(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [None, 0.0, 0.1, 0.5, 0.9, 0.999, 1.0])
def test_top_p_logits_equals_reference(p):
    x = _logits(2)
    want = np.asarray(ref.top_p_logits(jnp.asarray(x), p))
    got = port.top_p_logits(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_token_equals_reference_first_maximum():
    x = _logits(3)
    want = np.asarray(ref.greedy_token(jnp.asarray(x)))
    got = port.greedy_token(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1]) == 5 and int(got[2]) == 0


def _support(x, temperature, k, p):
    """The reference's filtered logits -> (support mask, probabilities)."""
    f = jnp.asarray(x) / max(temperature, 1e-6)
    f = ref.top_p_logits(ref.top_k_logits(f, k), p)
    return np.asarray(f) > -1e8, np.asarray(jax.nn.softmax(f, axis=-1))


@pytest.mark.parametrize("temperature,k,p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8), (0.8, 8, 0.9)])
def test_sample_token_distribution(temperature, k, p):
    row = (np.random.RandomState(4).randn(12) * 1.5).astype(np.float32)
    n = 20000
    x = np.repeat(row[None], n, axis=0)
    g = torch.Generator().manual_seed(5)
    toks = port.sample_token(torch.from_numpy(x), g, temperature, k, p)
    assert toks.dtype == torch.int32 and toks.shape == (n,)
    again = port.sample_token(torch.from_numpy(x),
                              torch.Generator().manual_seed(5),
                              temperature, k, p)
    torch.testing.assert_close(toks, again, atol=0, rtol=0)
    keep, prob = _support(row[None], temperature, k, p)
    toks = toks.numpy()
    assert keep[0, toks].all()              # only tokens in the support
    freq = np.bincount(toks, minlength=row.shape[0]) / n
    np.testing.assert_allclose(freq, prob[0], atol=0.02, rtol=0)


def test_sample_token_draws_from_the_generator_given():
    x = torch.from_numpy(_logits(5))
    a = port.sample_token(x, torch.Generator().manual_seed(1), 1.0, 50)
    b = port.sample_token(x, torch.Generator().manual_seed(1), 1.0, 50)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
