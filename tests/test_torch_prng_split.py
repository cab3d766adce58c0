"""rio_tpu_torch.ops.prng's keys and shaped draws against jax.random on the same seeds.

``prng_key`` and ``split`` must equal ``jax.random.PRNGKey`` and
``jax.random.split`` word for word (this JAX runs with
``jax_threefry_partitionable``); ``normal_of(key, shape)`` lies within 1e-6
of ``jax.random.normal(key, shape, float32)``: the same bits, with XLA's
float32 erfinv evaluated by torch (see ``tests/test_torch_prng.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch.ops import prng  # noqa: E402

NORMAL_TOL = 1e-6
SEEDS = [0, 1, 18, 2**31 - 1, 2**32 + 5, 123456789012, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax_prngkey(seed):
    got = prng.prng_key(seed).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got.astype(np.uint32), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 3, 8, 1000])
@pytest.mark.parametrize("seed", [0, 18, 2**31 - 1, 123456789012])
def test_split_equals_jax_random_split(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.prng_key(seed), num).numpy()
    assert got.shape == (num, 2) and got.min() >= 0 and got.max() < 2**32
    assert np.array_equal(got.astype(np.uint32), want)


def test_split_of_a_split_key_equals_jax():
    """Keys from a split are keys: splitting one again follows JAX's tree."""
    jk = jax.random.split(jax.random.split(jax.random.PRNGKey(7))[1], 4)
    tk = prng.split(prng.split(prng.prng_key(7))[1], 4)
    assert np.array_equal(tk.numpy().astype(np.uint32), np.asarray(jk))


@pytest.mark.parametrize("shape", [(1000, 16), (32768, 16), (16, 64), (16, 1024), (7,), (3, 5, 2)],
                         ids=str)
@pytest.mark.parametrize("seed", [0, 18])
def test_normal_of_is_jax_random_normal(seed, shape):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    t1, t2 = prng.split(prng.prng_key(seed))
    for jk, tk in ((k1, t1), (k2, t2)):
        want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        got = prng.normal_of(tk, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert np.abs(got.numpy() - want).max() <= NORMAL_TOL


def test_normal_of_a_seed_key_is_the_per_seed_draw():
    """A key ``(0, seed)`` draws what ``normal(seeds, dim)`` draws for that seed."""
    seeds = torch.tensor([0, 5, 2**31 - 1], dtype=torch.int64)
    rows = torch.stack([prng.normal_of(prng.prng_key(int(s)), (16,)) for s in seeds])
    assert torch.equal(rows, prng.normal(seeds, 16))


def test_normal_of_draws_on_the_keys_device():
    key = prng.prng_key(18, "cpu")
    assert prng.normal_of(key, (4, 4)).device == key.device
    assert prng.split(key, 3).device == key.device
