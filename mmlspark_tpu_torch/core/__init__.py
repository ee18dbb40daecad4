from .schema import Table, ColumnMeta, find_unused_column_name
from .params import (
    Param,
    ServiceParam,
    Params,
    HasInputCol,
    HasOutputCol,
    HasInputCols,
    HasOutputCols,
    HasLabelCol,
    HasFeaturesCol,
    HasWeightCol,
    HasPredictionCol,
    HasScoresCol,
    HasScoredLabelsCol,
    HasScoredProbabilitiesCol,
    HasEvaluationMetric,
    HasSeed,
    HasBatchSize,
)
from .serialize import register_stage, registry, save_stage, load_stage, stage_class
from .pipeline import (
    PipelineStage,
    Transformer,
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    pipeline_model,
    Timer,
)
from .config import get_config, set_config
from .logging import get_logger
from .table_io import (
    read_csv,
    write_csv,
    read_parquet,
    write_parquet,
    from_pandas,
    to_pandas,
    DeviceTable,
)
from .fusion import (
    DeviceKernel,
    FusionPlan,
    FusedPipelineModel,
    ResidentExecutor,
    fuse,
    kernel_of,
    plan_fusion,
)
