"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu for one NVIDIA
H100 (Hopper, sm_90a).

It keeps the JAX package's stage names, Params, save formats and outputs.
Every kernel the JAX package wrote in Pallas for the TPU is a kernel written
by hand for Hopper in `csrc/`. Entry points run on the card (`device="cuda"`)
unless the caller asks for the CPU.

Ported so far: GBDT fit and score (`gbdt`: every objective, multiclass,
gbdt / goss / rf / dart, bagging, early stopping, warm start, checkpointed
and preemptible fits, LightGBM model.txt import and export, data- and
voting-parallel fits over a mesh of processes), the mesh as a
torch.distributed process group with its collectives and the bit-exact
fixed-point merge (`parallel`), random draws equal to `jax.random`'s
(`core.prng`), DNN serving through
`DeepModelTransformer` and DNN training through `DNNLearner` (data-parallel
over the mesh too), with the flash-attention forward and its backward,
transfer learning through `ImageFeaturizer` over checkpoints that the
model zoo (`ModelDownloader`) imports (`nn`), the image pipeline
(`image`: `ImageTransformer` on a port of `jax.image.resize`), the
pipeline core and async data plane (`core`), tabular ingest (`core`:
`read_csv` on the native CSV parser, parquet and pandas, `DeviceTable`),
the utility and featurization stages (`ops`: `Featurize`,
`CleanMissingData`, `ValueIndexer`, `Cacher` onto the card, ...), text
featurization (`text`: `TextFeaturizer` and its stages), the checkpointer
and its host chain (`resilience`, `observability`, `utils`), seeded
tables (`utils.datagen`), host native kernels (`native`), evaluation
metrics and the featurize-then-fit trainers (`automl`: `TrainClassifier`,
`TrainRegressor`), pipeline fusion (`core.fuse`: adjacent device stages
as one program, a CUDA graph a shape on the card, every stage's
`device_kernel`) and serving (`io_http`: `serve_model` and
`ServingServer`, JSON and the binary wire, the resident hot path over a
fused segment, the batch-mode journal), the serving fleet (`io_http`:
`ServingFleet`, one spawned replica process with its own CUDA context a
host, behind `ServingGateway` or `GatewayTier`, scaled by
`FleetAutoscaler`; `observability`'s fleet metrics, SLOs and timeline),
the HTTP client side (`http_send`, `HTTPClient`, `TargetPool`,
`HTTPTransformer`, `SimpleHTTPTransformer`, `PartitionConsolidator`), the
typed REST stages (`io_http`: cognitive services, `AzureSearchWriter`,
`PowerBIWriter`), recommendation (`recommendation`: `SAR` and its resident
top-k server, `RecommendationIndexer`, the ranking metrics and stages) and
AutoML (`automl`: `TuneHyperparameters`, `FindBestModel`, the hyperband
`SweepScheduler` over worker processes, `ImageLIME`; `gbdt.shared_bins`;
`resilience`'s supervisors). ROADMAP.md lists what is still to come.

The CPU tests hold each module against the JAX package's
(`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py`; the fleet's:
`tests/test_torch_serving_fleet.py`, `test_torch_gateway.py`,
`test_torch_observability_fleet.py`, `test_torch_timeline.py`,
`test_torch_io_http_clients.py`). On the card, `python3 chip_smoke.py`
drives every slice, the fleet in its `slice_fleet` phase.
"""

import torch

# f32 matmuls and convolutions in full f32, as the reference's
# Precision.HIGHEST (mmlspark_tpu/gbdt/hist_kernel.py:64-70)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_SUBPACKAGES = ("core", "gbdt", "automl", "image", "io_http", "native", "nn",
                "observability", "ops", "parallel", "recommendation", "resilience", "text",
                "utils")


def __getattr__(name):
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
