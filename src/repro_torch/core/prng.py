"""A numpy twin of jax's threefry2x32 PRNG on raw ``(2,)`` uint32 keys.

The JAX package draws the ``eps_greedy`` exploration uniforms and the
``markov`` churn uniforms with ``jax.random.split`` and
``jax.random.uniform(..., jnp.float32)`` from the run's
``EngineState.rng_key`` (a raw ``np.array([0, seed], uint32)`` key). The
port reproduces those bits on the host with this module, so seeded runs of
both packages take the same decisions.

jax has two forms of the key split and of the random bits, picked by its
``jax_threefry_partitionable`` flag:

- partitionable (jax's default from 0.5): element i of a shape is counted
  by its flat index as a 64-bit (hi, lo) pair; ``split`` hashes the pair
  and keeps both words, the bits are the xor of the two words;
- original: the counts are ``0 .. 2m-1`` split into two halves that are
  hashed together, and the outputs concatenated.

The port cannot read jax's config, so ``PARTITIONABLE`` mirrors it; it
defaults to True (jax 0.9.0's default). ``set_partitionable`` flips it.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["PARTITIONABLE", "set_partitionable", "threefry2x32", "split",
           "random_bits", "uniform"]

PARTITIONABLE = True

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def set_partitionable(value: bool) -> None:
    """Mirror ``jax.config.jax_threefry_partitionable``."""
    global PARTITIONABLE
    PARTITIONABLE = bool(value)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``
    (uint32 arrays of one shape) under ``key``; returns the two output
    words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, dtype=np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hash_flat(key, counts):
    """jax's ``threefry_2x32(key, counts)``: a flat count vector split in
    two halves (zero-padded to even length), hashed, concatenated."""
    n = counts.shape[0]
    padded = np.concatenate([counts, np.zeros(n % 2, np.uint32)])
    half = padded.shape[0] // 2
    y0, y1 = threefry2x32(key, padded[:half], padded[half:])
    return np.concatenate([y0, y1])[:n]


def _iota_hi_lo(size):
    idx = np.arange(size, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` on a raw key: ``(num, 2)`` uint32."""
    key = np.asarray(key, dtype=np.uint32)
    with np.errstate(over="ignore"):
        if PARTITIONABLE:
            b0, b1 = threefry2x32(key, *_iota_hi_lo(num))
            return np.stack([b0, b1], axis=1)
        counts = np.arange(num * 2, dtype=np.uint32)
        return _hash_flat(key, counts).reshape(num, 2)


def random_bits(key, shape) -> np.ndarray:
    """jax's 32-bit ``random_bits(key, 32, shape)``: uint32 of ``shape``."""
    key = np.asarray(key, dtype=np.uint32)
    size = math.prod(shape)
    with np.errstate(over="ignore"):
        if PARTITIONABLE:
            b0, b1 = threefry2x32(key, *_iota_hi_lo(size))
            bits = b0 ^ b1
        else:
            bits = _hash_flat(key, np.arange(size, dtype=np.uint32))
    return bits.reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32)`` in [0, 1): the top
    23 bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, tuple(shape))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return floats - np.float32(1.0)
