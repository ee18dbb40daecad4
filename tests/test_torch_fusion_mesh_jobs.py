"""Jobs that the ranks of a `RankPool` run for the port's fused pipelines
under a mesh of several ranks (tests/test_torch_fusion_mesh.py): the
data-parallel and tensor-parallel fused MLP, the fused GBDT traversal,
the skew gauge, steady-state cache counters, sharded uploads, and shard 0
leading a StreamingQuery and a server while the other ranks follow.

A rank is a spawned process, so this module imports only numpy, torch and
mmlspark_tpu_torch. Every rank of the pool runs every job, in the same
order, and builds the job's mesh (process groups are collective); a rank
outside the mesh returns None. Inputs arrive whole, as every rank of a
mesh is handed the same table.
"""

from __future__ import annotations

import datetime
import json
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.core.fusion import fuse
from mmlspark_tpu_torch.core.pipeline import pipeline_model
from mmlspark_tpu_torch.parallel import make_mesh
from mmlspark_tpu_torch.parallel.mesh import Mesh

_MESHES: dict = {}


def _mesh(n_data: int, n_model: int = 1):
    key = (n_data, n_model)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(n_data=n_data, n_model=n_model)
    return _MESHES[key]


def _member(mesh) -> bool:
    return dist.get_rank() in mesh.ranks


def _mlp_stages(bundle_bytes: bytes, bs: int, fetch=None):
    from mmlspark_tpu_torch.nn.models import ModelBundle
    from mmlspark_tpu_torch.nn.runner import DeepModelTransformer
    from mmlspark_tpu_torch.ops.conversion import DataConversion

    kw = {} if fetch is None else {"fetch_dict": fetch}
    runner = DeepModelTransformer(input_col="x", mini_batch_size=bs, device="cpu", **kw) \
        .set_model(ModelBundle.from_bytes(bundle_bytes))
    if fetch is not None:
        return [runner]
    return [runner, DataConversion(cols=["output"], convert_to="float")]


def gbdt_model(text: str):
    from mmlspark_tpu_torch.gbdt import Booster
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel

    model = GBDTRegressionModel(features_col="features", prediction_col="prediction")
    model.booster = Booster.from_text(text, device="cpu")
    return model


def _result(mesh, fm, out, cols) -> dict:
    seg = fm._ensure_segments()[0]
    return {"shard": mesh.shard_index, "cols": {c: np.asarray(out[c]) for c in cols},
            "stats": fm.last_stats, "describe": fm.describe(),
            "eager": seg.eager_collectives}


def fused_mlp(bundle_bytes: bytes, x, bs: int, n_data: int, n_model: int = 1, fetch=None):
    """The MLP (and a DataConversion when `fetch` is None) fused under a
    data x model mesh: the whole table's outputs on every rank."""
    mesh = _mesh(n_data, n_model)
    if not _member(mesh):
        return None
    fm = fuse(pipeline_model(*_mlp_stages(bundle_bytes, bs, fetch)), mesh=mesh,
              mini_batch_size=bs, device="cpu")
    out = fm.transform(Table({"x": x}))
    return _result(mesh, fm, out, ["output"] if fetch is None else list(fetch))


def fused_gbdt(text: str, x, bs: int, n_data: int):
    """The GBDT regressor's fused traversal under a data mesh."""
    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    fm = fuse(pipeline_model(gbdt_model(text)), mesh=mesh, mini_batch_size=bs, device="cpu")
    out = fm.transform(Table({"features": x}))
    res = _result(mesh, fm, out, ["prediction"])
    res["params_whole"] = _params_whole(fm._ensure_segments()[0], gbdt_model(text))
    return res


def _params_whole(seg, model) -> bool:
    """Whether this rank holds every binning and tree array whole."""
    want = model.booster.device_predict_fn(device="cpu")[0]

    def leaves(t):
        if isinstance(t, dict):
            return [v for k in sorted(t) for v in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [v for e in t for v in leaves(e)]
        return [t] if isinstance(t, torch.Tensor) else []

    mine, full = leaves(seg._device_params[0]), leaves(want)
    return len(mine) == len(full) and all(torch.equal(a, b) for a, b in zip(mine, full))


def skew(bundle_bytes: bytes, x, bs: int, n_data: int, label: str):
    """The shard-skew gauge and the armed ledger's per-rank shard table."""
    from mmlspark_tpu_torch.observability import metrics, profiler

    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    prof = profiler.Profiler(registry=metrics.MetricsRegistry(), enabled=True)
    prev = profiler.set_default_profiler(prof)
    try:
        fm = fuse(pipeline_model(*_mlp_stages(bundle_bytes, bs)), mesh=mesh,
                  mini_batch_size=bs, device="cpu", fused_label=label)
        fm.transform(Table({"x": x}))
    finally:
        profiler.set_default_profiler(prev)
    gauge = metrics.get_registry().gauge(
        "mmlspark_tpu_shard_skew_ratio", labels=("pipeline", "mesh_shape")).labels(
            pipeline=label, mesh_shape=fm.last_stats["mesh_shape"])
    (row,) = prof.attribution()
    return {"shard": mesh.shard_index,
            "ratio": fm.last_stats["segments"][0]["shard_skew_ratio"], "gauge": gauge.value,
            "shards": sorted(s["shard"] for s in row["shards"])}


def steady(bundle_bytes: bytes, warm: list, more: list, bs: int, n_data: int):
    """Executable-cache counters after warming every rung, and after more
    tables of other row counts."""
    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    fm = fuse(pipeline_model(*_mlp_stages(bundle_bytes, bs)), mesh=mesh, mini_batch_size=bs,
              device="cpu")
    for x in warm:
        fm.transform(Table({"x": x}))
    seg = fm._ensure_segments()[0]
    before = seg._exec_cache.stats()
    for x in more:
        fm.transform(Table({"x": x}))
    return {"shard": mesh.shard_index, "before": before, "after": seg._exec_cache.stats()}


def upload(cols: dict, n_data: int, listed: list):
    """This rank's upload of `cols` with the `listed` columns sharded."""
    from mmlspark_tpu_torch.core.table_io import DeviceTable

    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    dt = DeviceTable.from_host(cols, shardings={c: mesh for c in listed}, device="cpu")
    return {"shard": mesh.shard_index, "cols": {c: dt[c].numpy() for c in cols}}


def stream(text: str, batches: list, bs: int, n_data: int):
    """A StreamingQuery of the GBDT regressor over a MemorySource of
    `batches` under a data mesh: shard 0 runs it and returns its sink, the
    other ranks follow and return the runs they followed."""
    from mmlspark_tpu_torch.streaming.query import StreamingQuery
    from mmlspark_tpu_torch.streaming.sources import MemorySource

    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    source = MemorySource()
    fm = fuse(pipeline_model(gbdt_model(text)), mini_batch_size=bs, device="cpu")
    q = StreamingQuery(source=source, transform=fm, mesh=mesh, device="cpu",
                       source_lookahead=0)
    if q.following:
        runs = q.process_all_available()
        q.stop()
        return {"shard": mesh.shard_index, "following": True, "runs": runs}
    n = 0
    for b in batches:                  # one micro-batch each
        source.add_rows(Table({"features": b}))
        n += q.process_all_available()
    sink = q.sink.table()
    q.stop()
    return {"shard": 0, "following": False, "batches": n,
            "prediction": np.asarray(sink["prediction"]),
            "mesh_shape": fm.last_stats["mesh_shape"]}


def _post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _drive(srv, bodies: list, clients: int = 4) -> list:
    replies = [None] * len(bodies)
    errors = []

    def client(k):
        try:
            for i in range(k, len(bodies), clients):
                replies[i] = _post(srv.url, bodies[i])
        except Exception as e:  # noqa: BLE001 — reported to the test
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise RuntimeError(f"clients failed: {errors[:3]}")
    return replies


def _wait_ready(srv, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not srv.ready:
        if time.monotonic() > deadline:
            raise TimeoutError("the server never became ready")
        time.sleep(0.02)


def serve(text: str, bodies: list, n_data: int):
    """serve_model of the fused GBDT regressor under a data mesh: shard 0
    serves `bodies` (forced onto the resident route after a pass on the
    crossover's), the others follow and return what they did."""
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import serve_model

    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    warm = HTTPRequestData.from_json("/", json.loads(bodies[0]))
    srv = serve_model(pipeline_model(gbdt_model(text)), input_cols=["a", "b", "c"], mesh=mesh,
                      device="cpu", max_batch_size=16, warmup_request=warm)
    if isinstance(srv, dict):
        return {"shard": mesh.shard_index, "followed": srv}
    try:
        _wait_ready(srv)
        hp = srv.hot_path
        first = _drive(srv, bodies)
        hp.force_path = "resident"
        forced = _drive(srv, bodies)
        return {"shard": 0, "replies": first, "forced": forced,
                "resident_batches": hp.resident_batches, "disabled": hp.disabled,
                "ladder": list(srv.bucketer.ladder),
                "data_axis": hp.executor.data_axis_size}
    finally:
        srv.stop()


def serve_sar(cols: dict, users: list, n_data: int):
    """serve_recommender of a SAR model fitted from `cols` under a data
    mesh: shard 0's replies for `users`; the others follow."""
    from mmlspark_tpu_torch.recommendation import SAR, serve_recommender

    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    model = SAR(support_threshold=1, device="cpu").fit(Table(dict(cols)))
    srv = serve_recommender(model, mesh=mesh, device="cpu", max_batch_size=16)
    if isinstance(srv, dict):
        return {"shard": mesh.shard_index, "followed": srv}
    try:
        _wait_ready(srv)
        srv.hot_path.force_path = "sar_resident"
        replies = _drive(srv, [json.dumps({"user": u}).encode() for u in users])
        return {"shard": 0, "replies": replies, "resident_batches": srv.hot_path.resident_batches,
                "placements": list(srv.hot_path.executor.segment._param_placements)}
    finally:
        srv.stop()


def gone(text: str, x, timeout_s: float):
    """(1) shard 0 leads a fused run on a 2-rank mesh whose other rank is
    gone (it never follows): the run raises, and so does every later op;
    (2) a follower whose shard 0 never sends: `_follow` raises. Each mesh
    has its own group with a `timeout_s` timeout."""
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = [dist.new_group([0, 1], timeout=timeout) for _ in range(2)]
    rank = dist.get_rank()
    if rank > 1:
        return None
    out = {}
    fm = fuse(pipeline_model(gbdt_model(text)), mini_batch_size=64, device="cpu",
              mesh=Mesh((0, 1), groups[0]))
    if rank == 0:
        fm._open_lead()
        t0 = time.monotonic()
        try:
            fm.transform(Table({"features": x}))
            out["lead"] = None
        except RuntimeError as e:
            out["lead"] = repr(e)
        out["lead_s"] = time.monotonic() - t0
        try:
            fm.transform(Table({"features": x}))
            out["again"] = None
        except RuntimeError as e:
            out["again"] = repr(e)
        fm._close_lead()
    fm = fuse(pipeline_model(gbdt_model(text)), mini_batch_size=64, device="cpu",
              mesh=Mesh((0, 1), groups[1]))
    if rank == 1:
        t0 = time.monotonic()
        try:
            fm._follow()
            out["follow"] = None
        except RuntimeError as e:
            out["follow"] = repr(e)
        out["follow_s"] = time.monotonic() - t0
    return out


def fused_transformer(bundle_bytes: bytes, tokens, bs: int, n_data: int, device: str = "cuda"):
    """A flash transformer fused under a data mesh on `device`, transformed
    twice: the second run's outputs, the segment's graph counters and the
    K2 launches (by path) of each run, counted in this rank."""
    from mmlspark_tpu_torch.nn.attention import flash_attention
    from mmlspark_tpu_torch.nn.models import ModelBundle
    from mmlspark_tpu_torch.nn.runner import DeepModelTransformer

    mesh = _mesh(n_data)
    if not _member(mesh):
        return None
    runner = DeepModelTransformer(input_col="x", bfloat16=False, device=device,
                                  fetch_dict={"probability": "probability"}).set_model(
        ModelBundle.from_bytes(bundle_bytes))
    fm = fuse(pipeline_model(runner), mesh=mesh, mini_batch_size=bs, device=device)
    runs = []
    for _ in range(2):
        seg = fm._ensure_segments()[0]
        forwards = seg.forwards
        flash_attention.launches, flash_attention.launches_by_path = 0, {}
        out = fm.transform(Table({"x": tokens}))
        runs.append({"forwards": seg.forwards - forwards,
                     "k2": dict(flash_attention.launches_by_path),
                     "captures": seg.captures, "replays": seg.replays})
    return {"shard": mesh.shard_index, "cols": {"probability": np.asarray(out["probability"])},
            "runs": runs, "stats": fm.last_stats}
