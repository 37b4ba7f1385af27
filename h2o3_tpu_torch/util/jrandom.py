"""``jax.random`` as the booster uses it, bit for bit, in plain PyTorch.

The JAX package draws every random number of a tree fit (row and column
sampling, per-node mtries) through ``jax.random`` with the default
``threefry2x32`` generator in partitionable mode
(``jax_threefry_partitionable=True``) and 32-bit seeds (x64 off). This
module reproduces those calls so that a seeded fit here samples the same
rows and features as the JAX package:

- ``PRNGKey(seed)`` -> ``(0, seed mod 2**32)``: the seed goes through
  ``int64`` and then ``int32`` with x64 off, so only its low 32 bits stay
  (``PRNGKey(-1) == (0, 4294967295)``, ``PRNGKey(2**32 + 9) == (0, 9)``);
- ``split(key, num)``: key i is the threefry hash of the counter (0, i);
- ``fold_in(key, data)``: the hash of the counter (0, data mod 2**32);
- ``uniform(key, shape, device)``: float32 in [0, 1). Element j (row-major
  flat index) hashes the counter (j >> 32, j mod 2**32), XORs the two words,
  keeps the top 23 bits as the mantissa of a float in [1, 2) and subtracts
  1. A draw of n values is therefore the first n values of any longer draw
  with the same key, and a (K, F) draw is the (K*F,) draw reshaped. With
  ``minval``/``maxval`` (DeepLearning's weight init) the draw u becomes
  ``max(minval, u * (maxval - minval) + minval)`` in float32, the product
  and the sum fused into one rounding as XLA fuses them (``addcmul``);
- ``bernoulli(key, p, shape, device)``: ``uniform(key, shape) < p`` with p
  rounded to float32 (DeepLearning's dropout masks).

A key is a pair of Python ints (the two uint32 words), so deriving keys
costs no device work and no synchronisation; only ``uniform`` touches a
device, with ``int64`` tensor ops (``& 0xFFFFFFFF`` after every add and
shift, since torch's ``uint32`` has few ops and ``>>`` on ``int32`` is
arithmetic). There is no global state. This is the counterpart of XLA code
in the JAX package, not of a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The 20-round Threefry-2x32 hash of the counter words (x0, x1) under
    the key words (k0, k1). Words are Python ints or int64 tensors holding
    values in [0, 2**32); the result has the same form."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 — the name of the JAX call
    """The key ``jax.random.PRNGKey(seed)`` gives with x64 off."""
    return (0, int(seed) & _MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` as a list of ``num`` keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: Key, shape: Sequence[int],
                device: Union[str, torch.device]) -> torch.Tensor:
    """32 random bits per element, as int64 in [0, 2**32), on ``device``."""
    n = math.prod(shape)
    j = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], j >> 32, j & _MASK)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], device: Union[str, torch.device],
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``: float32 in [0, 1) by default."""
    bits = random_bits(key, shape, device)
    # < 2**31, so the int32 cast keeps every bit
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = one_to_two - 1.0
    if minval == 0.0 and maxval == 1.0:
        return u  # u * 1 + 0 and max(0, u) give u's bits
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, torch.addcmul(lo.expand_as(u), u, hi - lo))


def bernoulli(key: Key, p: float, shape: Sequence[int],
              device: Union[str, torch.device]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool, True with probability
    p (p is a Python float, float32 in JAX with x64 off)."""
    return uniform(key, shape, device) < torch.tensor(p, dtype=torch.float32)
