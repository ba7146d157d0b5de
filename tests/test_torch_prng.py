"""The port's threefry twin (``repro_torch/core/prng.py``) against
``jax.random``, bit for bit: ``split`` and ``uniform(..., float32)`` on
raw ``(2,)`` uint32 keys, over 60 keys (the engines' ``[0, seed]`` layout
and random full-width ones), every shape the engines draw and a long one,
under both ``jax_threefry_partitionable`` modes."""
import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SHAPES = ((1,), (3,), (25,), (2, 25), (1000,))
MODES = (True, False)


def _keys():
    keys = [np.array([0, s & 0xFFFFFFFF], np.uint32)
            for s in (0, 1, 2, 7, 11, 2 ** 31 - 1, 2 ** 32 - 1)]
    rng = np.random.default_rng(0)
    keys += [rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
             for _ in range(53)]
    return keys


KEYS = _keys()


@pytest.fixture
def mode(request):
    """Set jax's partitionable flag and the twin's mirror together."""
    value = request.param
    prev = prng.PARTITIONABLE
    prng.set_partitionable(value)
    with jax.threefry_partitionable(value):
        yield value
    prng.set_partitionable(prev)


def test_default_mirrors_the_installed_jax():
    assert prng.PARTITIONABLE == bool(jax.config.jax_threefry_partitionable)


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("num", (2, 3))
def test_split_matches_jax(mode, num):
    for key in KEYS:
        ref = np.asarray(jax.random.split(jnp.asarray(key), num))
        out = prng.split(key, num)
        assert out.dtype == np.uint32
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax_bitwise(mode, shape):
    for key in KEYS:
        ref = np.asarray(jax.random.uniform(jnp.asarray(key), shape,
                                            jnp.float32))
        out = prng.uniform(key, shape)
        assert out.dtype == np.float32 and out.shape == shape
        np.testing.assert_array_equal(out.view(np.uint32),
                                      ref.view(np.uint32))


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_key_chain_matches_the_engines_draws(mode):
    """Thirty slots of the engines' pattern — split, keep the first key,
    draw from the second — stay equal down the chain."""
    key_j = jnp.asarray(np.array([0, 11], np.uint32))
    key_t = np.array([0, 11], np.uint32)
    for _ in range(30):
        k2, sub = jax.random.split(key_j)
        ref = np.asarray(jax.random.uniform(sub, (2, 16), jnp.float32))
        key_t, sub_t = prng.split(key_t)
        np.testing.assert_array_equal(prng.uniform(sub_t, (2, 16)), ref)
        np.testing.assert_array_equal(key_t, np.asarray(k2))
        key_j = k2
