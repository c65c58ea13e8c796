"""ops/sampling.py against timeviper_tpu/ops/sampling.py: the logits the JAX
sampler hands to jax.random.categorical (captured by a stand-in), after its
temperature, top-k and top-p masks, equal the port's filter_logits (the same
-inf set, the kept values to f32 rounding); the port's draws from a
torch.Generator fall inside the kept set and repeat for a seed; greedy is the
argmax in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng, t

from timeviper_tpu.ops import sampling as jax_sampling
from timeviper_tpu_torch.ops.sampling import SamplingParams, filter_logits, sample_token

CASES = [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.8), (0.9, 12, 0.6), (1.0, 1, 0.5)]


def _jax_filtered(logits, params, monkeypatch):
    seen = []

    def categorical(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax_sampling.jax.random, "categorical", categorical)
    jax_sampling.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                              jax_sampling.SamplingParams(*params))
    return seen[0]


@pytest.mark.parametrize("params", CASES)
def test_masks_match_jax_and_samples_stay_inside(params, monkeypatch):
    logits = (rng(1).standard_normal((4, 64)) * 3).astype(np.float32)
    logits[1, 10:14] = logits[1].max()  # a tie at the top
    want = _jax_filtered(logits, params, monkeypatch)
    got = filter_logits(t(logits), SamplingParams(*params)).numpy()
    keep = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), keep)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    g = torch.Generator().manual_seed(3)
    draws = torch.stack([sample_token(t(logits), g, SamplingParams(*params))
                         for _ in range(200)], 1).numpy()
    assert all(keep[b, draws[b]].all() for b in range(4))
    again = sample_token(t(logits), torch.Generator().manual_seed(3), SamplingParams(*params))
    np.testing.assert_array_equal(again.numpy(), draws[:, 0])


def test_greedy_is_the_argmax():
    logits = rng(2).standard_normal((3, 50)).astype(np.float32)
    want = np.asarray(jax_sampling.sample_token(jnp.asarray(logits), None))
    np.testing.assert_array_equal(sample_token(t(logits), None).numpy(), want)
    np.testing.assert_array_equal(
        sample_token(t(logits), torch.Generator(), SamplingParams()).numpy(), want)
