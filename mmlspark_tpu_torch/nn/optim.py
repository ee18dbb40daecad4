"""The trainer's optimizers: the port's copy of the optax pieces it uses.

The JAX trainer takes `optax.adam`, `adamw`, `sgd`, `sgd(momentum=0.9)` and
`rmsprop` at their defaults (mmlspark_tpu/nn/trainer.py:46-52), and freezes
parameters with `optax.multi_transform({"train": tx, "freeze":
optax.set_to_zero()}, labels)`. These are optax 0.2.6's formulas, term for
term, on f32 tensors under torch.no_grad():

- adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count + 1,
  u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + 0) + eps),
  b1 0.9, b2 0.999, eps 1e-8, eps_root 0;
- adamw: adam's u + 1e-4 p (`add_decayed_weights`, before the learning
  rate, as optax chains it);
- sgd: u = g; momentum: trace = g + 0.9 trace, u = trace;
- rmsprop: nu = 0.1 g^2 + 0.9 nu, u = g rsqrt(nu + 1e-8) (eps inside the
  square root, initial nu 0);
- then p + (-lr) u.

torch.optim is not used: its RMSprop adds eps outside the square root and
its AdamW decays by 1e-2 times the learning rate. The bias corrections
b^count are taken in f64 and rounded to f32, which is what XLA's f32 `pow`
gives for these counts (1 - 0.999^count loses most of its bits, so a
differently rounded power would move every Adam step).

`Optimizer.state_tree` lays the state out as optax's state pytree after
`flax.serialization.to_state_dict`: a tuple of the chain's states with
their field names (`count`, `mu`, `nu`, `trace`; {} for a stateless
transform), under `{"inner_states": {"freeze": {"inner_state": {}},
"train": {"inner_state": ...}}}` when some parameters are frozen, whose
moments are then empty dicts (optax's masked nodes). So a snapshot of
either package resumes in the other.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["OPTIMIZERS", "Optimizer"]

OPTIMIZERS = ("adam", "adamw", "sgd", "momentum", "rmsprop")

# each optimizer's moments, and the number of states in its optax chain
_SLOTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": (), "momentum": ("trace",),
          "rmsprop": ("nu",)}
_CHAIN = {"adam": 2, "adamw": 3, "sgd": 2, "momentum": 2, "rmsprop": 3}
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_WEIGHT_DECAY = 1e-4
_MOMENTUM = 0.9
_RMS_DECAY = 0.9


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in f32, the power rounded from f64."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


class Optimizer:
    """One of OPTIMIZERS at `learning_rate`, over a list of f32 tensors."""

    def __init__(self, name: str, learning_rate: float):
        if name not in _SLOTS:
            raise ValueError(f"unknown optimizer {name!r}; have {list(OPTIMIZERS)}")
        self.name = name
        self.lr = float(learning_rate)
        self.slots = _SLOTS[name]

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        """{"count": 0, slot: [zeros like each param]}."""
        state: dict = {"count": 0}
        for slot in self.slots:
            state[slot] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: dict) -> None:
        """One optax update, applied in place to `params` and `state`."""
        params, grads = list(params), list(grads)
        if not params:
            return
        name = self.name
        if name in ("adam", "adamw"):
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, _B1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - _B1))
            torch._foreach_mul_(nu, _B2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - _B2))
            state["count"] += 1
            mu_hat = torch._foreach_div(mu, _bias_correction(_B1, state["count"]))
            nu_hat = torch._foreach_div(nu, _bias_correction(_B2, state["count"]))
            denom = torch._foreach_sqrt(torch._foreach_add(nu_hat, 0.0))
            torch._foreach_add_(denom, _EPS)
            updates = torch._foreach_div(mu_hat, denom)
            if name == "adamw":
                torch._foreach_add_(updates, torch._foreach_mul(params, _WEIGHT_DECAY))
        elif name == "momentum":
            trace = state["trace"]
            torch._foreach_mul_(trace, _MOMENTUM)
            torch._foreach_add_(trace, grads)
            updates = trace
        elif name == "rmsprop":
            nu = state["nu"]
            torch._foreach_mul_(nu, _RMS_DECAY)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                       1 - _RMS_DECAY))
            updates = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, _EPS)),
                                         grads)
        else:
            updates = grads
        torch._foreach_add_(params, torch._foreach_mul(updates, -self.lr))

    # -- optax's state layout ------------------------------------------- #

    def state_tree(self, state: dict, tree_of: Callable[[list], Any], frozen: bool) -> Any:
        """optax's state dict of `state`; `tree_of(tensors)` lays one slot
        (aligned with the trained parameters) out as a flax params tree."""
        first: dict = {}
        if self.name in ("adam", "adamw"):
            first["count"] = np.array(state["count"], dtype=np.int32)
        for slot in self.slots:
            first[slot] = tree_of(state[slot])
        inner = (first,) + ({},) * (_CHAIN[self.name] - 1)
        if frozen:
            return {"inner_states": {"freeze": {"inner_state": {}},
                                     "train": {"inner_state": inner}}}
        return inner

    def load_state_tree(self, tree: Any, tensors_of: Callable[[Any], list],
                        frozen: bool) -> dict:
        """The inverse of `state_tree`: `tensors_of(params_tree)` gives one
        slot's tensors aligned with the trained parameters."""
        first = (tree["inner_states"]["train"]["inner_state"] if frozen else tree)["0"]
        state: dict = {"count": int(first["count"]) if "count" in first else 0}
        for slot in self.slots:
            state[slot] = tensors_of(first[slot])
        return state
