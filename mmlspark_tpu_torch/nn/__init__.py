"""Deep-model subsystem of the port: architectures, the ModelBundle
container, batched inference (`DeepModelTransformer`) and training
(`DNNLearner`, `DNNModel`; optax's optimizers in nn/optim.py), with the
flash-attention forward (K2) as a hand-written CUDA kernel and its
backward ported as torch code; transfer-learning featurization
(`ImageFeaturizer`), the model zoo (`ModelDownloader`) and the importers
of torch-layout checkpoints (nn/import_weights.py).

Counterpart of mmlspark_tpu/nn/.
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
from .featurizer import ImageFeaturizer
from .zoo import ModelSchema, ModelDownloader, retry_with_timeout
from .import_weights import import_external_weights

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
    "ImageFeaturizer",
    "ModelSchema",
    "ModelDownloader",
    "retry_with_timeout",
    "import_external_weights",
]
