"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu for one NVIDIA
H100 (Hopper, sm_90a).

It keeps the JAX package's stage names, Params, save formats and outputs.
Every kernel the JAX package wrote in Pallas for the TPU is a kernel written
by hand for Hopper in `csrc/`. Entry points run on the card (`device="cuda"`)
unless the caller asks for the CPU.

Ported so far: GBDT fit and score (`gbdt`: every objective, multiclass,
gbdt / goss / rf / dart, bagging, early stopping, warm start), random
draws equal to `jax.random`'s (`core.prng`), DNN serving through
`DeepModelTransformer` with the flash-attention forward (`nn`), the
pipeline core and async data plane (`core`), host native kernels
(`native`) and classification metrics (`automl`). ROADMAP.md lists what
is still to come.
"""

import torch

# f32 matmuls and convolutions in full f32, as the reference's
# Precision.HIGHEST (mmlspark_tpu/gbdt/hist_kernel.py:64-70)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_SUBPACKAGES = ("core", "gbdt", "automl", "native", "nn")


def __getattr__(name):
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
