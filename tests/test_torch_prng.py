"""The port's numpy threefry key chain is bit-equal to `jax.random`
(JAX 0.9, partitionable threefry) for every call the tick makes, over
60 keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch import prng

torch.set_num_threads(2)

KEYS = [np.asarray(jax.random.PRNGKey(s * 7919 + 3)) for s in range(60)]


def test_split_matches_jax():
    for k in KEYS:
        for n in (2, 5, 6):
            assert np.array_equal(np.asarray(jax.random.split(k, n)),
                                  prng.split(k, n))


def test_bits_matches_jax():
    for k in KEYS:
        for shape in ((4,), (3, 5), ()):
            assert np.array_equal(
                np.asarray(jax.random.bits(k, shape, jnp.uint32)),
                prng.bits(k, shape))


def test_uniform_matches_jax():
    for k in KEYS:
        a = np.asarray(jax.random.uniform(k), np.float32)
        assert a.view(np.uint32) == np.float32(prng.uniform(k)).view(
            np.uint32)


@pytest.mark.parametrize("lo,hi", [(0, 4), (50, 101), (3, 10), (7, 7)])
def test_randint_matches_jax(lo, hi):
    for k in KEYS:
        assert int(jax.random.randint(k, (), lo, hi)) == \
            int(prng.randint(k, lo, hi))


def test_bernoulli_matches_jax():
    got = [prng.bernoulli(k) for k in KEYS]
    assert got == [bool(jax.random.bernoulli(k)) for k in KEYS]
    assert 0 < sum(got) < len(got)
    for p in (0.1, 0.9):
        assert [prng.bernoulli(k, p) for k in KEYS] == \
            [bool(jax.random.bernoulli(k, p)) for k in KEYS]


def test_key_stacks_draw_per_key():
    """A stack of keys [B, 2] draws what each key draws alone (the
    per-world key chains of a batch)."""
    ks = np.stack(KEYS[:7])
    assert np.array_equal(prng.split(ks, 5),
                          np.stack([prng.split(k, 5) for k in KEYS[:7]]))
    assert np.array_equal(prng.bits(ks, (3, 2)),
                          np.stack([prng.bits(k, (3, 2)) for k in KEYS[:7]]))
    for fn in (prng.uniform, lambda k: prng.randint(k, 3, 10),
               prng.bernoulli):
        assert np.array_equal(fn(ks), np.array([fn(k) for k in KEYS[:7]]))
