"""The port's counter-based draws (mmlspark_tpu_torch/core/prng.py) against
`jax.random`, bit for bit: `prng_key` against `PRNGKey`, `fold_in` against
`fold_in`, `uniform` against `uniform` (float32), on the CPU.

Only jax's partitionable threefry scheme is ported, so a JAX whose
default changes must fail here loudly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mmlspark_tpu_torch.core import prng  # noqa: E402

# seeds the fits use: 0, the defaults (bagging 3, feature 2, drop 4), the
# gates' 42, the largest int32, and the seeds default_rng(42) derives for
# dart (booster.py's master-seed derivation)
_DERIVED = [int(s) for s in np.random.default_rng(42).integers(2**31, size=3)]
SEEDS = [0, 2, 3, 4, 42, 2**31 - 1] + _DERIVED


def _key_ints(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key))


def test_jax_draws_with_the_partitionable_scheme():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == _key_ints(key)
    for data in (0, 1, 2, 3, 99, 100, 101, 999, 1000):
        assert prng.fold_in(prng.prng_key(seed), data) == _key_ints(jax.random.fold_in(key, data))
    # the loop's nesting: round, then purpose
    for it in (0, 7, 29):
        for purpose in (1, 2, 100):
            want = jax.random.fold_in(jax.random.fold_in(key, it), purpose)
            got = prng.fold_in(prng.fold_in(prng.prng_key(seed), it), purpose)
            assert got == _key_ints(want)


@pytest.mark.parametrize("n", [14, 1200, 32768])
@pytest.mark.parametrize("seed", [0, 3, 42, 2**31 - 1, _DERIVED[0]])
def test_uniform_matches_jax_bit_for_bit(seed, n):
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 3), 1)
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), 3), 1)
    want = np.asarray(jax.random.uniform(jkey, (n,)))
    got = prng.uniform(key, (n,), "cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_uniform_of_a_2d_shape_and_the_raw_bits_match_jax():
    jkey = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.uniform(jkey, (3, 7)))
    np.testing.assert_array_equal(prng.uniform(prng.prng_key(5), (3, 7), "cpu").numpy(), want)
    bits = np.asarray(jax.random.bits(jkey, (50,), dtype=np.uint32))
    np.testing.assert_array_equal(prng.random_bits(prng.prng_key(5), (50,), "cpu").numpy(),
                                  bits.astype(np.int64))


def test_an_element_depends_only_on_its_index():
    key = prng.prng_key(42)
    long = prng.uniform(key, (5000,), "cpu")
    assert torch.equal(prng.uniform(key, (14,), "cpu"), long[:14])


def test_seeds_outside_int32_are_refused():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2**31)
