"""The weight carry between flax variables and the port's torch modules.

`load_variables(module, variables)` installs a JAX `ModelBundle.variables`
tree ({"params": ..., "batch_stats": ...} of numpy arrays, flax layout)
into a model of nn/models.py; `module_variables(module)` is its inverse,
which `ModelBundle.init` and `save` use. This is the one place where
layouts convert, through each layer's `flax_leaves`/`load_flax_leaves`
(nn/layers.py): HWIO conv kernels <-> OIHW weights, Dense and
DenseGeneral kernels <-> (out, in) weights, `batch_stats` <-> the
BatchNorm buffers.

The tree is validated leaf for leaf before anything is installed, as the
JAX package's `_validate_and_install` does (import_weights.py:354): every
path present on both sides, with the same shape.

The trainer keeps tensors shaped like the parameters (the optimizer's
moments) in torch layout: `param_paths` names each parameter's flax leaf,
and `params_tree` / `params_from_tree` carry such tensors to the flax
layout of a "params" tree and back, through the same layer methods.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

__all__ = ["load_variables", "module_variables", "param_paths", "params_tree",
           "params_from_tree"]


def _layers(module: nn.Module) -> Iterator[tuple[tuple[str, ...], nn.Module]]:
    """(flax module path, layer) of every module that owns flax leaves."""
    for name, mod in module.named_modules():
        if hasattr(mod, "flax_leaves"):
            yield (tuple(name.split(".")) if name else ()), mod


def module_variables(module: nn.Module) -> dict[str, Any]:
    """The flax-layout variables tree of `module`'s weights (numpy copies)."""
    tree: dict[str, Any] = {}
    for path, layer in _layers(module):
        for (collection, leaf), value in layer.flax_leaves().items():
            node = tree.setdefault(collection, {})
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _leaf_shapes(tree: Any, prefix: tuple = ()) -> dict[tuple, tuple]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, prefix + (str(k),)))
        return out
    return {prefix: tuple(np.shape(tree)) if not isinstance(tree, torch.Tensor)
            else tuple(tree.shape)}


def load_variables(module: nn.Module, variables: dict[str, Any]) -> nn.Module:
    """Install `variables` into `module` in place (returns it). Raises
    ValueError naming the missing, unexpected and mis-shaped leaves when
    the tree does not fit the architecture."""
    want = _leaf_shapes(module_variables(module))
    got = _leaf_shapes(variables)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mis = [k for k in want if k in got and want[k] != got[k]]
    if missing or extra or mis:
        detail = "; ".join(filter(None, [
            f"missing {['/'.join(k) for k in missing[:5]]}" if missing else "",
            f"unexpected {['/'.join(k) for k in extra[:5]]}" if extra else "",
            f"shape mismatch {[('/'.join(k), got[k], want[k]) for k in mis[:5]]}"
            if mis else "",
        ]))
        raise ValueError(f"variables do not fit {type(module).__name__}: {detail}")
    with torch.no_grad():
        for path, layer in _layers(module):
            leaves = {}
            for collection, leaf in layer.flax_leaves():
                node = variables[collection]
                for part in path:
                    node = node[part]
                leaves[(collection, leaf)] = node[leaf]
            layer.load_flax_leaves(leaves)
    return module


def param_paths(module: nn.Module) -> dict[str, tuple]:
    """torch parameter name -> the path of its leaf in the flax "params"
    tree (e.g. "attn_0.query.weight" -> ("attn_0", "query", "kernel"))."""
    out = {}
    for path, layer in _layers(module):
        for pname, _ in layer.named_parameters(recurse=False):
            out[".".join(path + (pname,))] = path + (layer.flax_names[pname],)
    return out


def params_tree(module: nn.Module, tensors: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The flax-layout "params" tree (numpy) of `tensors`, one for every
    parameter of `module` by torch name, each shaped like it."""
    named = dict(module.named_parameters())
    saved = {n: p.data for n, p in named.items()}
    try:
        with torch.no_grad():
            for n, p in named.items():
                p.data = tensors[n]
            return module_variables(module)["params"]
    finally:
        for n, p in named.items():
            p.data = saved[n]


def _fill(tree: Any, full: Any) -> Any:
    """`tree` with every empty-dict leaf (optax's masked node) taken from
    `full`."""
    if isinstance(full, dict):
        return {k: _fill(tree[k], v) for k, v in full.items()}
    return full if isinstance(tree, dict) and not tree else tree


def params_from_tree(module: nn.Module, tree: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The inverse of `params_tree`: torch name -> tensor (torch layout, on
    the module's device) of a flax "params" tree; empty-dict leaves take
    the module's own parameter."""
    variables = module_variables(module)
    variables["params"] = _fill(tree, variables["params"])
    shadow = load_variables(copy.deepcopy(module), variables)
    return {n: p.data for n, p in shadow.named_parameters()}
