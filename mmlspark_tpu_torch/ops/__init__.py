"""Utility pipeline stages of the port: column stages, indexing, imputation,
conversion, profiling, sampling, aggregation, adapters, featurization and
mini-batching. Copies of mmlspark_tpu/ops (host numpy code); `Cacher` puts
columns on the card. `CleanMissingDataModel`, `DataConversion` and
`AssembleFeaturesModel` declare `device_kernel`s, which run in fused
segments (core/fusion.py); `EnsembleByKey` declares why it cannot."""

from .stages import (
    DropColumns,
    SelectColumns,
    RenameColumn,
    Repartition,
    Explode,
    Lambda,
    UDFTransformer,
    Cacher,
    CheckpointData,
    TextPreprocessor,
    ClassBalancer,
    ClassBalancerModel,
    get_value_at,
    to_vector,
)
from .indexer import ValueIndexer, ValueIndexerModel, IndexToValue
from .missing import CleanMissingData, CleanMissingDataModel
from .conversion import DataConversion
from .summarize import SummarizeData
from .sample import PartitionSample
from .ensemble import EnsembleByKey
from .adapter import MultiColumnAdapter, MultiColumnAdapterModel
from .featurize import Featurize, AssembleFeatures, AssembleFeaturesModel
from .minibatch import (
    FixedMiniBatchTransformer,
    DynamicMiniBatchTransformer,
    TimeIntervalMiniBatchTransformer,
    FlattenBatch,
)
