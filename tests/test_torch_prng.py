"""rio_tpu_torch.ops.prng and _hash_features against jax.random on the same seeds.

The threefry words must equal ``jax.random.bits`` exactly (this JAX runs
with ``jax_threefry_partitionable``). The features come from the same bits
through ``sqrt(2) * erfinv(u)``; the port evaluates XLA's float32 erfinv
polynomial with torch's ``log1p``/``sqrt``, so features are held within
5e-5 absolute of ``_hash_features``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu.object_placement.jax_placement import _hash_features as jax_hash_features  # noqa: E402
from rio_tpu.object_placement.jax_placement import _pad_feature_block as jax_pad_block  # noqa: E402

from rio_tpu_torch.object_placement import torch_placement as tp  # noqa: E402
from rio_tpu_torch.ops import prng  # noqa: E402

FEATURE_TOL = 5e-5


def _crc_seeds(keys):
    return np.asarray([zlib.crc32(k.encode()) & 0x7FFFFFFF for k in keys], np.uint32)


def _keys(n):
    rng = np.random.default_rng(0)
    keys = [f"Obj.{i}" for i in range(n - 6)]
    keys += ["", "é", "Ωmega.漢字", "\x00pad:0", f"\x00pad:{n}", str(rng.integers(1 << 62))]
    return keys


def _jax_bits(seeds, dim):
    draw = jax.vmap(lambda s: jax.random.bits(jax.random.PRNGKey(s), (dim,)))
    return np.asarray(draw(jnp.asarray(seeds)))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1], ids=["0", "1", "2^31-1"])
def test_threefry_words_equal_jax_random_bits(seed):
    seeds = np.asarray([seed], np.uint32)
    want = _jax_bits(seeds, 16)
    got = prng.random_bits(torch.tensor([seed], dtype=torch.int64), 16).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    assert np.array_equal(got.astype(np.uint32), want)


def test_threefry_words_equal_jax_random_bits_on_4096_crc32_seeds():
    seeds = _crc_seeds(_keys(4096))
    want = _jax_bits(seeds, 16)
    got = prng.random_bits(torch.from_numpy(seeds.astype(np.int64)), 16).numpy()
    assert np.array_equal(got.astype(np.uint32), want)


def test_normal_matches_jax_random_normal_on_the_same_bits():
    seeds = _crc_seeds(_keys(4096))
    draw = jax.vmap(lambda s: jax.random.normal(jax.random.PRNGKey(s), (16,)))
    want = np.asarray(draw(jnp.asarray(seeds)))
    got = prng.normal(torch.from_numpy(seeds.astype(np.int64)), 16).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= FEATURE_TOL


def test_hash_features_match_jax_on_4096_keys():
    keys = _keys(4096)
    want = np.asarray(jax_hash_features(keys))
    got = tp._hash_features(keys)
    assert got.shape == (4096, tp._FEAT_DIM) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= FEATURE_TOL
    # Width follows dim, and keys hash independently of their batch.
    assert tp._hash_features(keys[:5], 7).shape == (5, 7)
    assert torch.equal(tp._hash_features(keys[100:101]), got[100:101])


def test_pad_feature_block_matches_jax_and_is_cached(monkeypatch):
    dev = torch.device("cpu")
    monkeypatch.setattr(tp, "_PAD_BLOCKS", {})
    block = tp._pad_feature_block(300, tp._FEAT_DIM, dev)
    assert block.shape == (300, tp._FEAT_DIM)
    assert np.abs(block.numpy() - jax_pad_block(300, 16)).max() <= FEATURE_TOL
    # One block per (dim, device): a smaller request is a view of its rows,
    # a larger one grows it by the missing rows only.
    again = tp._pad_feature_block(120, tp._FEAT_DIM, dev)
    assert again.data_ptr() == block.data_ptr() and torch.equal(again, block[:120])
    grown = tp._pad_feature_block(500, tp._FEAT_DIM, dev)
    assert torch.equal(grown[:300], block)
    assert np.abs(grown.numpy() - jax_pad_block(500, 16)).max() <= FEATURE_TOL
    assert len(tp._PAD_BLOCKS) == 1


def test_hash_features_in_chunks_equal_one_batch(monkeypatch):
    keys = _keys(1000)
    whole = tp._hash_features(keys)
    monkeypatch.setattr(tp, "_HASH_CHUNK_KEYS", 128)
    assert torch.equal(tp._hash_features(keys), whole)


def test_erfinv_is_xlas_polynomial():
    u = np.linspace(-1.0 + 2.0**-24, 1.0 - 2.0**-23, 20001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = prng.erfinv(torch.from_numpy(u)).numpy()
    assert np.abs(got - want).max() <= FEATURE_TOL
    ends = prng.erfinv(torch.tensor([-1.0, 1.0])).numpy()
    assert ends[0] < -1e38 and ends[1] > 1e38
