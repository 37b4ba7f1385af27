"""Parity: the port's ``util/jrandom.py`` against ``jax.random``, bit for bit.

The JAX package draws every sampled row, column and per-node feature set of
a tree fit through ``jax.random`` (threefry2x32, partitionable mode, x64
off). The port reproduces ``PRNGKey``, ``split``, ``fold_in``, ``uniform``
(also scaled to DeepLearning's init range) and ``bernoulli`` with torch
integer ops; here the uint32 words of every key, the float32 uniforms
(viewed as int32) and the masks must equal JAX's exactly, over a grid of
seeds that covers the 32-bit wrap (2^31 - 1, 2^31 + 3, 2^32 + 9, -1).
``test_fold_in`` and ``test_uniform_prefix_property`` are held in
``tests/test_torch_deeplearning.py``, which also derives DeepLearning's
keys.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu_torch.util import jrandom as jr

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 3, 2**32 + 9, -1]


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key, dtype=np.uint32))


def test_jax_runs_the_configuration_ported():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64
    # PRNGKey keeps the low 32 bits of the seed
    assert jr.PRNGKey(-1) == (0, 4294967295)
    assert jr.PRNGKey(2**32 + 9) == (0, 9)

    # the order in which the JAX block derives keys for one round and one
    # class's tree (booster.py:853, :881, :584, :607, :491)
    seed, tree, cls = 1234, 17, 2
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), tree)
    jkr, jkc, jkt = jax.random.split(jk, 3)
    jkey = jax.random.fold_in(jkt, cls)
    pkr, pkc, pkt = jr.split(jr.fold_in(jr.PRNGKey(seed), tree), 3)
    pkey = jr.fold_in(pkt, cls)
    assert (pkr, pkc, pkey) == (_words(jkr), _words(jkc), _words(jkey))
    for _ in range(3):  # three built levels of mtries draws
        jkey, jsub = jax.random.split(jkey)
        pkey, psub = jr.split(pkey)
        want = np.asarray(jax.random.uniform(jsub, (4, 6)))
        np.testing.assert_array_equal(
            jr.uniform(psub, (4, 6), "cpu").numpy().view(np.int32), want.view(np.int32))
    # a rank's row draw: elements [o, o + S) of the draw over the padded
    # rows, bit for bit the slice of the whole draw (JAX's and the port's)
    whole = np.asarray(jax.random.uniform(jkr, (1003,)))
    for o, size in ((0, 335), (335, 335), (670, 333), (1000, 3)):
        part = jr.uniform(pkr, (size,), "cpu", offset=o).numpy()
        np.testing.assert_array_equal(part.view(np.int32), whole[o:o + size].view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert jr.PRNGKey(seed) == _words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    want = [_words(k) for k in jax.random.split(jax.random.PRNGKey(seed), num)]
    assert jr.split(jr.PRNGKey(seed), num) == want


@pytest.mark.parametrize("shape", [(1,), (8,), (1001,), (4096,), (3, 5), (64, 28), (1024, 11)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, shape))
    got = jr.uniform(_words(key), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # DeepLearning's draws: the He-uniform init's U(-b, b) with b a float32
    # square root, and the dropout masks, bernoulli(1 - ratio)
    bound = jnp.sqrt(6.0 / (shape[0] + shape[-1] + 1))
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, -bound, bound))
    b = float(np.sqrt(np.float32(6.0 / (shape[0] + shape[-1] + 1))))
    got = jr.uniform(_words(key), shape, "cpu", -b, b)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    for p in (0.8, 0.5, 0.1):
        want = np.asarray(jax.random.bernoulli(key, p, shape))
        got = jr.bernoulli(_words(key), p, shape, "cpu")
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
