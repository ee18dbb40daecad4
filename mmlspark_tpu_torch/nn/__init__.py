"""Deep-model subsystem of the port: architectures, the ModelBundle
container, batched inference (`DeepModelTransformer`) and training
(`DNNLearner`, `DNNModel`; optax's optimizers in nn/optim.py), with the
flash-attention forward (K2) as a hand-written CUDA kernel and its
backward ported as torch code.

Counterpart of mmlspark_tpu/nn/. Not ported yet (ROADMAP Queue 1, P4):
`ImageFeaturizer`, the model zoo and the weight importers.
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
from .trainer import DNNLearner, DNNModel

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
    "DNNLearner",
    "DNNModel",
]
