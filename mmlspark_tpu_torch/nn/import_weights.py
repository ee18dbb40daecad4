"""External pretrained-weight ingestion: torch-layout state dicts -> flax.

Counterpart of mmlspark_tpu/nn/import_weights.py: the numpy mappers are
copied unchanged, so both packages build the same flax-layout variables
tree from the same checkpoint, bit for bit. The tree is then checked leaf
for leaf against the port's own model of that architecture and installed
in a port `ModelBundle`, whose torch module is built from it through
nn/carry.py.

Reference: the transfer-learning story rests on REAL pretrained models
pulled from a remote repo by `ModelDownloader` (ModelDownloader.scala:209+,
Schema.scala:30-119 — uri/hash/layerNames/inputNode) and cut at a layer by
`ImageFeaturizer` (ImageFeaturizer.scala:92-135). The CNTK-format model file
is the interchange artifact. Here the interchange artifact is the de-facto
standard for published CNN weights: a torch-style state dict (flat
name->tensor mapping, PyTorch/torchvision naming and layouts), shipped as
`.safetensors` or `.npz` — both readable without torch itself.

What the mapper translates (torchvision ResNet naming -> nn.models.ResNet):

  conv1.weight                 -> params/stem_conv/kernel   (OIHW -> HWIO)
  bn1.{weight,bias}            -> params/stem_bn/{scale,bias}
  bn1.running_{mean,var}       -> batch_stats/stem_bn/{mean,var}
  layer<L>.<B>.conv<N>.weight  -> params/stage<L-1>_block<B>/conv<N>/kernel
  layer<L>.<B>.bn<N>.*         -> params|batch_stats/.../bn<N>/*
  layer<L>.<B>.downsample.0.*  -> .../proj_conv/kernel
  layer<L>.<B>.downsample.1.*  -> .../proj_bn/*
  fc.{weight,bias}             -> params/head/{kernel,bias}  ((out,in) -> (in,out))

The result is validated leaf-for-leaf (path and shape) against the target
module's own `init` tree, so a wrong transpose or a missing block fails
loudly at import time, not silently at serving time.

Beyond the hand-written ResNet mapper, `MapRule`/`apply_mapping_spec`
define a DECLARATIVE mapping language (anchored regex -> target path +
layout transform) so new checkpoint families are a rule table, not a new
parser; `TRANSFORMER_SPEC` maps HF-style flat encoder state dicts
(`encoder.layer.<i>.attention.self.query.weight`, torch (out,in) layouts)
onto nn.models.TransformerEncoder. Note the architecture here is pre-LN
(ln before attention/mlp, final ln before pooling): checkpoints from
post-LN models (original BERT) carry the same tensor NAMES but different
math — importing one gives a well-formed model that is not
weight-equivalent to its source. The spec documents naming + layout, not
architectural equivalence.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np

__all__ = [
    "load_state_dict",
    "torch_resnet_to_flax",
    "import_torch_resnet",
    "MapRule",
    "apply_mapping_spec",
    "TRANSFORMER_SPEC",
    "torch_transformer_to_flax",
    "import_torch_transformer",
    "import_external_weights",
    "IMPORTERS",
]


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a flat name->array state dict from `.safetensors` or `.npz`.

    Both formats are readable with numpy-only code paths (safetensors via
    its numpy loader), so importing published weights needs no torch
    runtime — the analogue of the reference reading CNTK model bytes
    without the training toolchain (SerializableFunction.scala:85+)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".safetensors":
        from safetensors.numpy import load_file

        return dict(load_file(path))
    if ext == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    raise ValueError(
        f"unsupported weight format {ext!r}; expected .safetensors or .npz"
    )


_LAYER_RE = re.compile(
    r"^layer(?P<stage>\d+)\.(?P<block>\d+)\.(?P<rest>.+)$"
)


def _assign(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch conv weight OIHW -> flax HWIO."""
    if w.ndim != 4:
        raise ValueError(f"conv weight must be 4-D, got {w.shape}")
    return np.transpose(w, (2, 3, 1, 0))


def _map_bn(rest: str, prefix: tuple[str, ...], value, params, batch_stats,
            bn_name: str) -> bool:
    leaf = rest.split(".")[-1]
    if leaf == "weight":
        _assign(params, prefix + (bn_name, "scale"), value)
    elif leaf == "bias":
        _assign(params, prefix + (bn_name, "bias"), value)
    elif leaf == "running_mean":
        _assign(batch_stats, prefix + (bn_name, "mean"), value)
    elif leaf == "running_var":
        _assign(batch_stats, prefix + (bn_name, "var"), value)
    elif leaf == "num_batches_tracked":
        return True                                  # torch-only bookkeeping
    else:
        return False
    return True


def torch_resnet_to_flax(
    state_dict: Mapping[str, np.ndarray],
) -> dict[str, Any]:
    """Map a torchvision-style ResNet state dict to nn.models.ResNet
    variables ({"params": ..., "batch_stats": ...}). Raises ValueError on
    any unrecognized key — silent drops are how transposed/missing weights
    slip through to produce garbage activations."""
    params: dict[str, Any] = {}
    batch_stats: dict[str, Any] = {}
    for name, value in state_dict.items():
        value = np.asarray(value)
        if name == "conv1.weight":
            _assign(params, ("stem_conv", "kernel"), _conv_kernel(value))
            continue
        if name.startswith("bn1."):
            if _map_bn(name, (), value, params, batch_stats, "stem_bn"):
                continue
            raise ValueError(f"unrecognized stem bn key {name!r}")
        if name == "fc.weight":
            _assign(params, ("head", "kernel"), np.transpose(value, (1, 0)))
            continue
        if name == "fc.bias":
            _assign(params, ("head", "bias"), value)
            continue
        m = _LAYER_RE.match(name)
        if m is None:
            raise ValueError(f"unrecognized state-dict key {name!r}")
        stage = int(m.group("stage")) - 1            # torch layer1 -> stage0
        block = f"stage{stage}_block{int(m.group('block'))}"
        rest = m.group("rest")
        cm = re.match(r"^conv(\d+)\.weight$", rest)
        if cm:
            _assign(params, (block, f"conv{cm.group(1)}", "kernel"),
                    _conv_kernel(value))
            continue
        bm = re.match(r"^bn(\d+)\.(.+)$", rest)
        if bm and _map_bn(rest, (block,), value, params, batch_stats,
                          f"bn{bm.group(1)}"):
            continue
        dm = re.match(r"^downsample\.(\d)\.(.+)$", rest)
        if dm:
            if dm.group(1) == "0" and dm.group(2) == "weight":
                _assign(params, (block, "proj_conv", "kernel"),
                        _conv_kernel(value))
                continue
            if dm.group(1) == "1" and _map_bn(
                rest, (block,), value, params, batch_stats, "proj_bn"
            ):
                continue
        raise ValueError(f"unrecognized state-dict key {name!r}")
    return {"params": params, "batch_stats": batch_stats}


# --------------------------------------------------------------------- #
# declarative mapping specs                                             #
# --------------------------------------------------------------------- #


class MapRule(NamedTuple):
    """One mapping rule: `pattern` is an anchored regex over state-dict
    keys; `target` is a '/'-joined destination path whose FIRST segment
    names the collection (params | batch_stats), either a template string
    (regex group expansion via m.expand) or a callable(match) -> str;
    None drops the tensor (framework-only bookkeeping). `transform`
    (value, ctx) -> value converts torch layouts to flax (ctx carries
    model config the shapes alone can't determine, e.g. num_heads)."""

    pattern: str
    target: "str | Callable | None"
    transform: "Callable[[np.ndarray, dict], np.ndarray] | None" = None


def apply_mapping_spec(
    state_dict: Mapping[str, np.ndarray],
    rules: "list[MapRule]",
    ctx: "dict | None" = None,
) -> dict[str, Any]:
    """Run a rule table over a flat state dict -> flax variables.

    First matching rule wins; a key no rule matches raises (silent drops
    are how transposed/missing weights slip through to garbage
    activations — same contract as the hand-written ResNet mapper)."""
    ctx = ctx or {}
    compiled = [(re.compile(r.pattern), r) for r in rules]
    out: dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, value in state_dict.items():
        for cre, rule in compiled:
            m = cre.fullmatch(name)
            if m is None:
                continue
            if rule.target is None:
                break
            target = (rule.target(m) if callable(rule.target)
                      else m.expand(rule.target))
            path = tuple(target.split("/"))
            if path[0] not in out:
                raise ValueError(
                    f"rule for {name!r} targets unknown collection {path[0]!r}"
                )
            v = np.asarray(value)
            if rule.transform is not None:
                v = rule.transform(v, ctx)
            _assign(out[path[0]], path[1:], v)
            break
        else:
            raise ValueError(f"unrecognized state-dict key {name!r}")
    return out


def _t_transpose(v, ctx):
    """torch Dense (out, in) -> flax (in, out)."""
    return np.transpose(v, (1, 0))


def _t_qkv_kernel(v, ctx):
    """torch (D, D) projection -> flax MHA DenseGeneral (D, H, D//H)."""
    d_model, h = v.shape[1], ctx["num_heads"]
    return np.transpose(v, (1, 0)).reshape(d_model, h, v.shape[0] // h)


def _t_qkv_bias(v, ctx):
    h = ctx["num_heads"]
    return v.reshape(h, v.shape[0] // h)


def _t_attn_out_kernel(v, ctx):
    """torch (D_out, D_in) output projection -> flax (H, D_in//H, D_out)."""
    h = ctx["num_heads"]
    return np.transpose(v, (1, 0)).reshape(h, v.shape[1] // h, v.shape[0])


# HF-style flat naming for a PRE-LN encoder (see module docstring for the
# post-LN caveat): attention.ln / mlp.ln are the pre-attention and pre-mlp
# layer norms, final_layer_norm closes the stack, classifier is the head.
TRANSFORMER_SPEC: "list[MapRule]" = [
    MapRule(r"embeddings\.word_embeddings\.weight", "params/embed/embedding"),
    MapRule(r"embeddings\.position_embeddings\.weight", "params/pos_embed"),
    MapRule(r"stem\.weight", "params/stem/kernel", _t_transpose),
    MapRule(r"stem\.bias", "params/stem/bias"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.attention\.ln\.weight",
            r"params/ln_attn_\g<i>/scale"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.attention\.ln\.bias",
            r"params/ln_attn_\g<i>/bias"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.attention\.self\."
            r"(?P<proj>query|key|value)\.weight",
            r"params/attn_\g<i>/\g<proj>/kernel", _t_qkv_kernel),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.attention\.self\."
            r"(?P<proj>query|key|value)\.bias",
            r"params/attn_\g<i>/\g<proj>/bias", _t_qkv_bias),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.attention\.output\.dense\.weight",
            r"params/attn_\g<i>/out/kernel", _t_attn_out_kernel),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.attention\.output\.dense\.bias",
            r"params/attn_\g<i>/out/bias"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.mlp\.ln\.weight",
            r"params/ln_mlp_\g<i>/scale"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.mlp\.ln\.bias",
            r"params/ln_mlp_\g<i>/bias"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.intermediate\.dense\.weight",
            r"params/mlp_up_\g<i>/kernel", _t_transpose),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.intermediate\.dense\.bias",
            r"params/mlp_up_\g<i>/bias"),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.output\.dense\.weight",
            r"params/mlp_down_\g<i>/kernel", _t_transpose),
    MapRule(r"encoder\.layer\.(?P<i>\d+)\.output\.dense\.bias",
            r"params/mlp_down_\g<i>/bias"),
    MapRule(r"final_layer_norm\.weight", "params/ln_final/scale"),
    MapRule(r"final_layer_norm\.bias", "params/ln_final/bias"),
    MapRule(r"classifier\.weight", "params/head/kernel", _t_transpose),
    MapRule(r"classifier\.bias", "params/head/bias"),
    MapRule(r".*\.num_batches_tracked", None),
]


def torch_transformer_to_flax(
    state_dict: Mapping[str, np.ndarray], num_heads: int,
) -> dict[str, Any]:
    """Map an HF-style flat encoder state dict onto
    nn.models.TransformerEncoder variables. num_heads is required: the
    fused (D, D) projection shapes cannot determine the head split."""
    return apply_mapping_spec(
        state_dict, TRANSFORMER_SPEC, {"num_heads": int(num_heads)}
    )


def _tree_leaves(tree: Any, prefix: str = "") -> dict[str, tuple[int, ...]]:
    out: dict[str, tuple[int, ...]] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_tree_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    out[prefix] = tuple(np.shape(tree))
    return out


def import_torch_resnet(
    path: str,
    architecture: str = "resnet50",
    num_outputs: int | None = None,
    input_shape: tuple[int, ...] = (224, 224, 3),
    preprocess: dict | None = None,
    class_labels=None,
    **config,
):
    """Load torch-layout ResNet weights into a ready-to-serve ModelBundle.

    The imported tree is validated leaf-for-leaf against the architecture's
    own init tree: every path must exist on both sides with the same shape.
    `num_outputs` defaults to the checkpoint's fc row count."""
    sd = load_state_dict(path)
    variables = torch_resnet_to_flax(sd)
    if num_outputs is None:
        fc = sd.get("fc.weight")
        if fc is None:
            raise ValueError("state dict has no fc.weight; pass num_outputs")
        num_outputs = int(np.asarray(fc).shape[0])

    bundle = _target_bundle(
        architecture, input_shape=tuple(input_shape),
        class_labels=class_labels,
        preprocess=dict(
            preprocess
            if preprocess is not None
            # torchvision ImageNet normalization, scaled to 0-255 inputs
            else {"mean": [123.675, 116.28, 103.53],
                  "std": [58.395, 57.12, 57.375]}
        ),
        num_outputs=int(num_outputs), **config,
    )
    return _validate_and_install(bundle, variables, architecture)


def _target_bundle(architecture: str, input_shape: tuple[int, ...], class_labels,
                   preprocess: dict, **config):
    """The bundle an import installs into: `ModelBundle.init`'s, without
    its random draws, which the import would overwrite (1.9 s for
    ResNet-50 on two CPU threads). Its variables are the uninitialised
    port module's tree, `carry.module_variables`, which defines the paths
    and shapes the imported tree must fit."""
    from .carry import module_variables
    from .models import ModelBundle, make_model

    module = make_model(architecture, input_shape, **config)
    return ModelBundle(
        architecture=architecture, config=config,
        variables=module_variables(module), input_shape=tuple(input_shape),
        class_labels=class_labels, preprocess=dict(preprocess))


def _validate_and_install(bundle, variables, architecture: str):
    """Leaf-for-leaf validation against the architecture's own tree (every
    path present on both sides, same shape), then install the imported
    arrays as float32 numpy leaves; `bundle.module` is built from them
    through `carry.load_variables` when first asked for. Shared by every
    importer so a new family can't skip the check."""
    want = _tree_leaves(bundle.variables)
    got = _tree_leaves(variables)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mis = [k for k in want if k in got and want[k] != got[k]]
    if missing or extra or mis:
        detail = "; ".join(
            filter(None, [
                f"missing {missing[:5]}" if missing else "",
                f"unexpected {extra[:5]}" if extra else "",
                f"shape mismatch {[ (k, got[k], want[k]) for k in mis[:5] ]}"
                if mis else "",
            ])
        )
        raise ValueError(f"imported weights do not fit {architecture}: {detail}")
    bundle.variables = {
        k: _as_f32(variables.get(k, {})) for k in bundle.variables
    }
    return bundle


def import_torch_transformer(
    path: str,
    architecture: str = "transformer",
    num_outputs: int | None = None,
    input_shape: tuple[int, ...] = (),
    preprocess: dict | None = None,
    class_labels=None,
    **config,
):
    """Load HF-style flat encoder weights into a ready-to-serve
    ModelBundle (the second imported family next to ResNet; reference
    parity anchor: ModelDownloader ingesting arbitrary published models,
    Schema.scala:30-119).

    Model dimensions are inferred from the checkpoint where shapes
    determine them (d_model/vocab_size from the embedding, num_layers
    from the layer indexes, d_ff from the mlp width, max_len from the
    position table, num_outputs from the classifier); `num_heads` cannot
    be inferred and must come from config (default 4)."""
    sd = load_state_dict(path)
    cfg = dict(config)
    emb = sd.get("embeddings.word_embeddings.weight")
    stem = sd.get("stem.weight")
    if emb is not None:
        cfg.setdefault("vocab_size", int(emb.shape[0]))
        cfg.setdefault("d_model", int(emb.shape[1]))
    elif stem is not None:
        cfg.setdefault("vocab_size", 0)
        cfg.setdefault("d_model", int(stem.shape[0]))
    else:
        raise ValueError(
            "state dict has neither embeddings.word_embeddings.weight nor "
            "stem.weight; not an encoder checkpoint this spec understands"
        )
    layer_ids = [
        int(m.group(1)) for m in
        (re.match(r"encoder\.layer\.(\d+)\.", k) for k in sd)
        if m is not None
    ]
    if not layer_ids:
        raise ValueError("state dict has no encoder.layer.<i> tensors")
    cfg.setdefault("num_layers", max(layer_ids) + 1)
    up0 = sd.get("encoder.layer.0.intermediate.dense.weight")
    if up0 is not None:
        cfg.setdefault("d_ff", int(up0.shape[0]))
    pos = sd.get("embeddings.position_embeddings.weight")
    if pos is not None:
        cfg.setdefault("max_len", int(pos.shape[0]))
    if num_outputs is None:
        head = sd.get("classifier.weight")
        if head is None:
            raise ValueError("state dict has no classifier.weight; "
                             "pass num_outputs")
        num_outputs = int(head.shape[0])
    cfg.setdefault("num_heads", 4)
    if cfg["d_model"] % cfg["num_heads"]:
        raise ValueError(
            f"d_model {cfg['d_model']} is not divisible by num_heads "
            f"{cfg['num_heads']}"
        )
    variables = torch_transformer_to_flax(sd, num_heads=cfg["num_heads"])

    if not input_shape:
        # one token position is enough to trace init; the pos table is
        # sized by max_len, not by the probe length
        input_shape = (8,) if cfg.get("vocab_size") else (8, 1)
    bundle = _target_bundle(
        architecture, input_shape=tuple(input_shape),
        class_labels=class_labels, preprocess=dict(preprocess or {}),
        num_outputs=int(num_outputs), **cfg,
    )
    return _validate_and_install(bundle, variables, architecture)


# architecture name -> importer; zoo.import_external dispatches here, so
# registering a new family makes it fetchable/verifiable end to end
IMPORTERS: "dict[str, Callable]" = {
    "resnet": import_torch_resnet,
    "resnet50": import_torch_resnet,
    "resnet20_cifar": import_torch_resnet,
    "transformer": import_torch_transformer,
}


def import_external_weights(path: str, architecture: str, **kw):
    """Dispatch an external checkpoint to its family importer."""
    imp = IMPORTERS.get(architecture)
    if imp is None:
        raise ValueError(
            f"no weight importer registered for architecture "
            f"{architecture!r}; known: {sorted(IMPORTERS)}"
        )
    return imp(path, architecture=architecture, **kw)


def _as_f32(tree):
    if isinstance(tree, Mapping):
        return {k: _as_f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)
