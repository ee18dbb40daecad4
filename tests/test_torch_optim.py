"""The port's optimizers (nn/optim.py) against optax 0.2.6.

The JAX trainer's five optimizers at their defaults, and its freeze
(`multi_transform` with `set_to_zero`), take 5 steps on one seeded tree with
the same seeded gradients in both packages. Gate: rtol 1e-6, atol 1e-7 on
the parameters and on every leaf of the optimizer state, whose layout must
be optax's state pytree after flax's `to_state_dict` key for key.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from mmlspark_tpu.nn.trainer import _OPTIMIZERS  # noqa: E402
from mmlspark_tpu_torch.nn import flax_blob  # noqa: E402
from mmlspark_tpu_torch.nn.optim import OPTIMIZERS, Optimizer  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
STEPS = 5
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}       # leaf order of the tree
LR = 3e-2


def _tree(rng):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _as_tree(values):
    return dict(zip(SHAPES, values))


def _run(name, frozen=()):
    rng = np.random.default_rng(5)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    tx = _OPTIMIZERS[name](LR)
    if frozen:
        tx = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()},
            {k: "freeze" if k in frozen else "train" for k in SHAPES})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    trained = [k for k in SHAPES if k not in frozen]
    opt = Optimizer(name, LR)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init([tp[k] for k in trained])
    for g in grads:
        opt.step([tp[k] for k in trained], [torch.from_numpy(g[k]) for k in trained], tstate)

    def tree_of(slot):
        out = {k: {} for k in SHAPES}
        out.update({k: t.numpy() for k, t in zip(trained, slot)})
        return out

    want_state = serialization.to_state_dict(jax.device_get(state))
    got_state = opt.state_tree(tstate, tree_of, bool(frozen))
    return jp, tp, want_state, got_state, opt, tree_of, trained


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        got = flax_blob._state_dict(got)
        assert isinstance(got, dict) and list(got) == list(want), (path, got, want)
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("frozen", [(), ("b",)], ids=["all", "freeze_b"])
def test_optimizer_matches_optax(name, frozen):
    jp, tp, want_state, got_state, *_ = _run(name, frozen)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    _assert_same_tree(got_state, want_state)


@pytest.mark.parametrize("name", ["adamw", "momentum", "rmsprop"])
def test_state_tree_round_trips_through_a_flax_blob(name):
    """state_tree -> to_bytes -> from_bytes -> load_state_tree gives the same
    state, and flax restores the same bytes into optax's own template."""
    jp, _, _, got_state, opt, _, trained = _run(name, ("b",))
    blob = flax_blob.to_bytes(got_state)
    back = opt.load_state_tree(flax_blob.from_bytes(blob),
                               lambda tree: [torch.from_numpy(np.array(tree[k])) for k in trained],
                               True)
    again = flax_blob.to_bytes(opt.state_tree(
        back, lambda slot: {**{k: {} for k in SHAPES},
                            **{k: t.numpy() for k, t in zip(trained, slot)}}, True))
    assert again == blob
    tx = optax.multi_transform({"train": _OPTIMIZERS[name](LR), "freeze": optax.set_to_zero()},
                               {k: "freeze" if k == "b" else "train" for k in SHAPES})
    template = jax.device_get(tx.init(jp))
    restored = serialization.from_bytes(template, blob)
    assert jax.tree.structure(restored) == jax.tree.structure(template)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        Optimizer("lamb", 1e-3)
