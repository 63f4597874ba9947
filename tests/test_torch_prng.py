"""The port's threefry PRNG (lmdeploy_tpu_torch/ops/prng.py) against
``jax.random`` on the CPU: keys, splits and bits exactly, draws up to
near-ties of the perturbed logits."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu_torch.ops import prng

SEEDS = [0, 1, 7, 2 ** 31 - 1]


def jkey(seed):
    return jax.random.PRNGKey(seed)


def tkey(seed):
    return torch.from_numpy(prng.key_from_seed(seed).view(np.int32))


def jwords(key):
    """JAX key data as the int32 words the port holds."""
    return np.asarray(jax.random.key_data(key)).view(np.int32)


@pytest.mark.parametrize('seed', SEEDS)
def test_key_split_and_bits_equal_jax(seed):
    np.testing.assert_array_equal(tkey(seed).numpy(), jwords(jkey(seed)))
    np.testing.assert_array_equal(
        prng.split(tkey(seed)[None], 3)[0].numpy(),
        np.asarray(jax.random.split(jkey(seed), 3)).view(np.int32))
    np.testing.assert_array_equal(
        prng.random_bits(tkey(seed)[None], (4, 33))[0].numpy(),
        np.asarray(jax.random.bits(jkey(seed), (4, 33), jnp.uint32))
        .astype(np.int64))


def test_keys_after_many_splits_equal_jax():
    """A batch of keys split 200 times as the engine does (keep half 0,
    draw from half 1): every key and every uniform draw is equal."""
    jk = jax.vmap(jkey)(jnp.asarray(SEEDS, jnp.uint32))
    tk = torch.from_numpy(np.stack([tkey(s).numpy() for s in SEEDS]))
    for _ in range(200):
        js = jax.vmap(jax.random.split)(jk)
        ts = prng.split(tk)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).view(np.int32))
        jk, tk = js[:, 0], ts[:, 0]
    ju = jax.vmap(lambda k: jax.random.uniform(k, (64,)))(js[:, 1])
    tu = prng.uniform(ts[:, 1], (64,))
    np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                  np.asarray(ju).view(np.int32))


@pytest.mark.parametrize('seed', SEEDS)
def test_uniform_and_gumbel_match_jax(seed):
    np.testing.assert_array_equal(
        prng.uniform(tkey(seed)[None], (5000,))[0].numpy(),
        np.asarray(jax.random.uniform(jkey(seed), (5000,))))
    lo, hi = np.float32(np.finfo(np.float32).tiny), np.float32(1.0)
    np.testing.assert_array_equal(
        prng.uniform(tkey(seed)[None], (5000,), float(lo), float(hi))[0]
        .numpy(),
        np.asarray(jax.random.uniform(jkey(seed), (5000,), minval=lo,
                                      maxval=hi)))
    # gumbel goes through log twice: XLA's and PyTorch's log may differ in
    # the last bit
    np.testing.assert_allclose(
        prng.gumbel(tkey(seed)[None], (5000,))[0].numpy(),
        np.asarray(jax.random.gumbel(jkey(seed), (5000,))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape', [(512,), (5, 300)])
def test_categorical_matches_jax_outside_near_ties(shape):
    """Identical f32 logits and keys draw the same index except where the
    top two perturbed logits lie within 1e-6 relative (XLA's log and
    PyTorch's may differ in the last bit); the test computes those draws
    and requires every other one to agree."""
    rng = np.random.default_rng(0)
    n = 64
    logits = (rng.normal(size=(n,) + shape) * 2).astype(np.float32)
    logits[:, ..., :7] = -1e30                     # NEG_INF entries
    keys = jax.random.split(jkey(3), n)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(logits)))
    tk = torch.from_numpy(np.asarray(keys).view(np.int32))
    got = prng.categorical(tk, torch.from_numpy(logits)).numpy()
    pert = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys)) \
        + logits
    top2 = np.sort(pert, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= 1e-6 * np.abs(top2[..., 1])
    assert (got[~tie] == want[~tie]).all()
    assert tie.mean() < 0.05
