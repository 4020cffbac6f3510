"""The torch port's sampler (``dynamo_tpu_torch.engine.sampling``) against the
JAX package's (``dynamo_tpu.engine.sampling``).

Greedy and top_k=1 lanes must pick the same token with the same logprob
(f32, 1e-5). The two use different random streams, so sampled lanes are
compared by distribution: empirical token frequencies within 4 sigma of the
softmax they sample from (the pattern of ``tests/test_spec.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts

torch.set_num_threads(2)

TOL = 1e-5


def _logits(seed, B, V):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3.0


def _jax_sample(logits, temp, top_p, top_k, seed=0):
    import jax

    keys = jax.random.split(jax.random.key(seed), logits.shape[0])
    tok, lp, _ = js.sample(jnp.asarray(logits), jnp.asarray(temp),
                           jnp.asarray(top_p), jnp.asarray(top_k), keys)
    return np.asarray(tok), np.asarray(lp)


def _torch_sample(logits, temp, top_p, top_k, u):
    tok, lp = ts.sample(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(top_p), torch.from_numpy(top_k),
                        torch.from_numpy(u))
    return tok.numpy(), lp.numpy()


def test_greedy_and_top_k_1_match_jax():
    B, V = 6, 259
    logits = _logits(0, B, V)
    # lanes 0-2 greedy; lanes 3-5 sample at temperature with top_k=1,
    # which leaves only the argmax in the window
    temp = np.asarray([0, 0, 0, 0.7, 1.0, 2.0], np.float32)
    top_p = np.asarray([1, 0.5, 1, 1, 0.9, 1], np.float32)
    top_k = np.asarray([0, 0, 5, 1, 1, 1], np.int64)
    u = np.random.default_rng(1).random(B).astype(np.float32)
    jt, jlp = _jax_sample(logits, temp, top_p, top_k.astype(np.int32))
    tt, tlp = _torch_sample(logits, temp, top_p, top_k, u)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, logits.argmax(-1))
    np.testing.assert_allclose(tlp, jlp, atol=TOL, rtol=0)


def test_apply_penalties_matches_jax():
    rng = np.random.default_rng(2)
    B, V = 4, 259
    logits = _logits(3, B, V)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    freq = np.asarray([0, 0.5, 1.0, 0], np.float32)
    pres = np.asarray([0, 0, 0.25, 1.5], np.float32)
    want = np.asarray(js.apply_penalties(jnp.asarray(logits),
                                         jnp.asarray(counts),
                                         jnp.asarray(freq), jnp.asarray(pres)))
    got = ts.apply_penalties(torch.from_numpy(logits),
                             torch.from_numpy(counts), torch.from_numpy(freq),
                             torch.from_numpy(pres)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # zero-penalty lanes are a bitwise no-op
    np.testing.assert_array_equal(got[0], logits[0])


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.8, 0, 1.0),        # plain temperature over the whole window
    (1.0, 3, 1.0),        # top-k renormalises the first three
    (1.0, 0, 0.6),        # nucleus: the smallest prefix with mass >= 0.6
])
def test_temperature_sampling_matches_softmax_within_4_sigma(temp, top_k,
                                                             top_p):
    V, N = 12, 20000
    row = np.asarray([2.0, 1.5, 1.2, 0.7, 0.3, 0.0, -0.4, -0.9, -1.3, -2.0,
                      -2.5, -3.0], np.float32)
    assert row.shape == (V,)
    p = np.exp(row / temp - (row / temp).max())
    p /= p.sum()
    order = np.argsort(-row)
    keep = np.ones(V, bool)
    if top_k:
        keep[order[top_k:]] = False
    if top_p < 1.0:
        cum = np.cumsum(p[order])
        keep[order[(cum - p[order]) >= top_p]] = False
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    gens = [ts.lane_generator(5)]
    u = ts.draw_uniforms(gens, N, torch.device("cpu"))[:, 0]
    tok, _ = ts.sample(torch.from_numpy(np.tile(row, (N, 1))),
                       torch.full((N,), temp), torch.full((N,), top_p),
                       torch.full((N,), top_k, dtype=torch.int64), u)
    freq = np.bincount(tok.numpy(), minlength=V) / N
    bound = 4 * np.sqrt(p * (1 - p) / N) + 1e-12
    assert np.all(np.abs(freq - p) <= bound), (freq, p)


def test_draws_are_deterministic_per_seed_and_resume_pos():
    logits = torch.from_numpy(np.tile(_logits(4, 1, 259), (16, 1)))
    one = torch.ones(16)

    def run(seed, resume_pos):
        g = ts.lane_generator(ts.resume_seed(seed, resume_pos))
        u = ts.draw_uniforms([g], 16, torch.device("cpu"))[:, 0]
        tok, _ = ts.sample(logits, one, one,
                           torch.zeros(16, dtype=torch.int64), u)
        return tok.tolist()

    assert run(7, 0) == run(7, 0)
    assert run(7, 3) == run(7, 3)
    assert run(7, 0) != run(7, 3)
    assert run(7, 0) != run(8, 0)


@pytest.mark.parametrize("seed,pos", [(0, 0), (7, 0), (7, 3),
                                      (2 ** 62 + 5, 11)])
def test_resume_seed_matches_jax(seed, pos):
    assert ts.resume_seed(seed, pos) == js.resume_seed(seed, pos)
