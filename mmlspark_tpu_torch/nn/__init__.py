"""Deep-model subsystem of the port: architectures, the ModelBundle
container and batched inference (`DeepModelTransformer`), with the
flash-attention forward (K2) as a hand-written CUDA kernel.

Counterpart of mmlspark_tpu/nn/. Not ported yet (ROADMAP Queue 1, P4):
the trainer (`DNNLearner`) and K2's backward, `ImageFeaturizer`, the
model zoo and the weight importers.
"""

from .models import (
    MLP,
    SimpleCNN,
    ResNet,
    TransformerEncoder,
    resnet20_cifar,
    resnet50,
    ARCHITECTURES,
    make_model,
    ModelBundle,
)
from .runner import DeepModelTransformer

__all__ = [
    "MLP",
    "SimpleCNN",
    "ResNet",
    "TransformerEncoder",
    "resnet20_cifar",
    "resnet50",
    "ARCHITECTURES",
    "make_model",
    "ModelBundle",
    "DeepModelTransformer",
]
