"""The port's collectives (mmlspark_tpu_torch/parallel/collectives.py) on
spawned gloo ranks, at 2, 4 and 8 shards: the cases of
tests/test_collectives_determinism.py:59-135, and the fixed-point merge
held bit for bit against the JAX package's on the same inputs.

One pool of 8 ranks serves the file (a `file://` rendezvous in tmp_path);
a mesh of fewer shards is a sub-group of it. The reference side runs on
the 8 CPU devices of tests/conftest.py, over the first `shards` of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
try:  # noqa: E402
    from jax import shard_map
except ImportError:  # jax < 0.5: shard_map lives under experimental
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from mmlspark_tpu.parallel import collectives as jax_collectives  # noqa: E402
from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402

import test_torch_mesh_jobs as jobs  # noqa: E402

WORLD = 8
SHARDS = [2, 4, 8]
# a shard -> rank table other than the identity, for each mesh size
PERMS = {2: [1, 0], 4: [2, 0, 3, 1], 8: [3, 1, 7, 5, 0, 2, 6, 4]}
# adversarial shard partials (reference test :33-35): catastrophic
# cancellation makes the f32 sum depend on the fold order
CANCELLING = np.array([3.0e7, 1.0, -3.0e7, 1.0, 1.0e7, 1.0, -1.0e7, 1.0], np.float32)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=60)
    yield p
    p.close()


def _port(pool, name, values, ranks) -> np.ndarray:
    """collectives.<name> of shard s's values[s], every shard's result in
    shard order: (S, ...) as the reference's out_specs=P(axis) stacks it."""
    out = [r for r in pool.run(jobs.reduce, name, values, list(ranks)) if r is not None]
    assert sorted(s for s, _ in out) == list(range(len(ranks)))
    return np.concatenate([v for _, v in sorted(out, key=lambda sv: sv[0])])


def _jax(fn, values, shards, perm=None) -> np.ndarray:
    """The reference's `_run` (test_collectives_determinism.py:45-56) over
    the first `shards` CPU devices, permuted by `perm`."""
    devs = jax.devices()[:shards]
    if perm is not None:
        devs = [devs[i] for i in perm]
    mesh = Mesh(np.asarray(devs), ("d",))
    x = jax.device_put(jnp.asarray(values, jnp.float32), NamedSharding(mesh, P("d")))
    return np.asarray(jax.jit(shard_map(
        lambda v: fn(v, "d"), mesh=mesh, in_specs=P("d"), out_specs=P("d")))(x))


def _fold(values) -> np.float32:
    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + v)
    return acc


def _hist_like(shards: int, seed: int) -> np.ndarray:
    """(S, F, B, 3) partials of a [grad, hess, count] histogram: channels
    of very different ranges, empty bins, a negative-heavy gradient."""
    rng = np.random.default_rng(seed)
    h = np.stack([rng.normal(scale=0.3, size=(shards, 5, 32)),
                  rng.random((shards, 5, 32)) * 0.25,
                  rng.integers(0, 900, (shards, 5, 32)).astype(np.float64)], axis=-1)
    h[:, :, 7:9] = 0.0
    h[:, 2, :, 0] -= 3.0
    return h.astype(np.float32)


@pytest.mark.parametrize("shards", SHARDS)
def test_psum_ordered_identical_on_all_ranks(pool, shards):
    out = _port(pool, "psum_ordered", CANCELLING[:shards], range(shards))
    assert np.all(out == out[0])


@pytest.mark.parametrize("shards", SHARDS)
def test_psum_ordered_matches_fixed_left_to_right_fold(pool, shards):
    out = _port(pool, "psum_ordered", CANCELLING[:shards], range(shards))
    assert out[0] == _fold(CANCELLING[:shards])
    # and the reference's fold on the same shards
    assert np.array_equal(out, _jax(jax_collectives.psum_ordered, CANCELLING[:shards], shards))


@pytest.mark.parametrize("shards", SHARDS)
def test_psum_ordered_invariant_under_rank_permutation(pool, shards):
    """The fold follows the mesh's shard order, so permuting which rank
    holds which shard cannot change the bits."""
    base = _port(pool, "psum_ordered", CANCELLING[:shards], range(shards))
    perm = _port(pool, "psum_ordered", CANCELLING[:shards], PERMS[shards])
    assert np.array_equal(base, perm)


@pytest.mark.parametrize("shards", SHARDS)
def test_psum_kahan_recovers_exact_sum(pool, shards):
    """Neumaier compensation gives the exact (float64) sum rounded once to
    float32, which left-to-right folding does not at 4 and 8 shards."""
    vals = CANCELLING[:shards]
    out = _port(pool, "psum_kahan", vals, range(shards))
    exact = np.float32(np.sum(vals.astype(np.float64)))
    assert np.all(out == out[0])
    assert out[0] == exact
    if shards > 2:
        assert _fold(vals) != exact


@pytest.mark.parametrize("shards", SHARDS)
def test_fixedpoint_bit_exact_under_shard_assignment_permutation(pool, shards):
    base = _port(pool, "psum_exact_fixedpoint", CANCELLING[:shards], range(shards))
    rng = np.random.default_rng(0)
    for _ in range(3):
        shuffled = CANCELLING[:shards][rng.permutation(shards)]
        out = _port(pool, "psum_exact_fixedpoint", shuffled, range(shards))
        assert np.array_equal(base, out)


@pytest.mark.parametrize("shards", SHARDS)
def test_fixedpoint_bit_exact_under_rank_permutation(pool, shards):
    vals = _hist_like(shards, seed=shards)
    base = _port(pool, "psum_exact_fixedpoint", vals, range(shards))
    perm = _port(pool, "psum_exact_fixedpoint", vals, PERMS[shards])
    assert np.array_equal(base, perm)
    assert np.all(base == base[0])


@pytest.mark.parametrize("shards", SHARDS)
def test_fixedpoint_accuracy_within_quantization_step(pool, shards):
    vals = np.random.default_rng(1).normal(size=shards).astype(np.float32)
    out = _port(pool, "psum_exact_fixedpoint", vals, range(shards))
    exact = float(np.sum(vals.astype(np.float64)))
    # step = max_abs * n / 2^23; the sum of n roundings is within n/2 steps
    step = float(np.abs(vals).max()) * shards / 2 ** 23
    assert abs(float(out[0]) - exact) <= shards / 2 * step
    assert np.all(out == out[0])


@pytest.mark.parametrize("shards", SHARDS)
def test_fixedpoint_zero_input(pool, shards):
    out = _port(pool, "psum_exact_fixedpoint", np.zeros(shards, np.float32), range(shards))
    assert np.all(out == 0.0)


@pytest.mark.parametrize("shards", SHARDS)
def test_fixedpoint_equals_the_jax_package_bit_for_bit(pool, shards):
    """Same inputs, same bits: the per-channel scale is the reference's
    float32 expression and torch.round rounds half to even."""
    for vals in (_hist_like(shards, seed=10 + shards), CANCELLING[:shards],
                 np.random.default_rng(2).normal(size=shards).astype(np.float32)):
        got = _port(pool, "psum_exact_fixedpoint", vals, range(shards))
        want = _jax(jax_collectives.psum_exact_fixedpoint, vals, shards)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shards", SHARDS)
def test_gather_scatter_follow_the_shard_table(pool, shards):
    """all_gather and reduce_scatter put shard s's block at s, also where
    the table permutes the ranks; pmin, pmean, axis_index, axis_size."""
    vals = np.arange(shards * 2 * shards, dtype=np.float32).reshape(shards, 2 * shards)
    for ranks in (list(range(shards)), PERMS[shards]):
        out = [r for r in pool.run(jobs.gather, vals, ranks) if r is not None]
        assert len(out) == shards
        for gathered, scattered, lo, mean, index, size in out:
            assert size == shards
            np.testing.assert_array_equal(gathered, vals.reshape(-1))
            np.testing.assert_array_equal(scattered, vals.sum(0)[2 * index:2 * index + 2])
            np.testing.assert_array_equal(lo, vals.min(0))
            np.testing.assert_allclose(mean, vals.mean(0), rtol=1e-6)
        assert sorted(o[4] for o in out) == list(range(shards))
