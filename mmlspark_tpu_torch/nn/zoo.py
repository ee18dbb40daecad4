"""Model zoo: schemas, repository, integrity-checked fetch.

Counterpart of mmlspark_tpu/nn/zoo.py, with the same `index.json` format
and bundle files: either package's `ModelDownloader` reads a repository the
other wrote. Bundles load as the port's `ModelBundle`, GBDT artifacts as
the port's `Booster`, and external checkpoints import through the port's
nn/import_weights.py.

Reference: `ModelDownloader` (src/downloader/src/main/scala/
ModelDownloader.scala:209+) — remote Azure-blob repo → local/HDFS repo, with
`ModelSchema` metadata (uri, hash, size, layerNames, inputNode;
Schema.scala:30+) and `FaultToleranceUtils.retryWithTimeout`
(ModelDownloader.scala:37-46). TPU equivalent: a filesystem repository of
ModelBundle files with sha256 integrity checks; remote sources are any
fsspec-style path (local path or file:// URI; http gated on environment).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from .models import ModelBundle

__all__ = ["ModelSchema", "ModelDownloader", "retry_with_timeout"]


def retry_with_timeout(fn: Callable, timeout_s: float = 60.0, retries: int = 3):
    """Reference: FaultToleranceUtils.retryWithTimeout
    (ModelDownloader.scala:37-46). Each attempt runs in a worker thread and
    is bounded by ``timeout_s`` even if ``fn`` hangs (the reference bounds
    the Await on the future the same way)."""
    import queue as _queue
    import threading

    last: Exception | None = None
    for attempt in range(retries):
        # one daemon thread per attempt: a hung fn neither blocks the caller
        # past timeout_s nor prevents interpreter exit (ThreadPoolExecutor
        # workers are non-daemon and joined at shutdown, so they can't be
        # used here); a timed-out attempt is retried like any other failure
        result_q: _queue.Queue = _queue.Queue(maxsize=1)

        def run(q=result_q):
            try:
                q.put((True, fn()))
            except Exception as e:  # noqa: BLE001 — retry semantics
                q.put((False, e))

        threading.Thread(target=run, daemon=True).start()
        try:
            ok, value = result_q.get(timeout=timeout_s)
        except _queue.Empty:
            last = TimeoutError(
                f"operation exceeded {timeout_s}s (attempt {attempt + 1})"
            )
        else:
            if ok:
                return value
            last = value
        if attempt < retries - 1:
            time.sleep(min(2**attempt, 10))
    raise last  # type: ignore[misc]


@dataclass
class ModelSchema:
    """Metadata for one zoo model (reference Schema.scala:30+)."""

    name: str
    uri: str                         # source path / file:// URI
    sha256: str | None = None
    architecture: str | None = None
    input_shape: tuple[int, ...] = ()
    num_outputs: int | None = None
    class_labels: list | None = None
    extra: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "uri": self.uri, "sha256": self.sha256,
            "architecture": self.architecture,
            "input_shape": list(self.input_shape),
            "num_outputs": self.num_outputs,
            "class_labels": self.class_labels, "extra": self.extra,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ModelSchema":
        return ModelSchema(
            name=d["name"], uri=d["uri"], sha256=d.get("sha256"),
            architecture=d.get("architecture"),
            input_shape=tuple(d.get("input_shape", ())),
            num_outputs=d.get("num_outputs"),
            class_labels=d.get("class_labels"), extra=d.get("extra", {}),
        )


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ModelDownloader:
    """Local repository of ModelBundles with integrity checking.

    `local_repo/index.json` lists ModelSchemas; bundle files live next to it.
    `download_model` copies from `schema.uri` (resolving file:// / local
    paths), verifies sha256, and registers the model in the index."""

    def __init__(self, local_repo: str):
        self.local_repo = local_repo
        os.makedirs(local_repo, exist_ok=True)
        self._index_path = os.path.join(local_repo, "index.json")

    # -- index ---------------------------------------------------------- #

    def models(self) -> list[ModelSchema]:
        if not os.path.exists(self._index_path):
            return []
        with open(self._index_path) as fh:
            return [ModelSchema.from_dict(d) for d in json.load(fh)]

    def get_model(self, name: str) -> ModelSchema:
        for s in self.models():
            if s.name == name:
                return s
        raise KeyError(f"model {name!r} not in repo {self.local_repo}")

    def _write_index(self, schemas: list[ModelSchema]) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump([s.to_dict() for s in schemas], fh, indent=2)
        os.replace(tmp, self._index_path)

    # -- fetch ---------------------------------------------------------- #

    def local_path(self, name: str) -> str:
        return os.path.join(self.local_repo, f"{name}.model")

    # suffixes a dot-prefixed work file can carry: ".tmp" while fetching,
    # or a bare external-format extension after import_external's rename
    # strips ".tmp" mid-conversion (a crash there orphans the renamed file)
    _WORK_SUFFIXES = (".tmp", ".safetensors", ".npz", ".pt", ".bin")

    def sweep_orphan_tmps(self, min_age_s: float = 3600.0) -> int:
        """Remove stale work files left by abandoned (timed-out or crashed)
        copy/convert workers: `*.tmp` (mkstemp artifacts, the index
        writer's rename source) plus dot-prefixed files with an
        external-format extension (import_external's post-rename tmp).
        Deliberately narrow — installed bundles (`*.model`), the index,
        and foreign dot-files (e.g. `.nfs*` silly-renames) never match.
        Age-gated: a fresh tmp may still be written by a live worker
        thread. Returns the number removed."""
        removed = 0
        now = time.time()
        for fname in os.listdir(self.local_repo):
            is_work = fname.endswith(".tmp") or (
                fname.startswith(".") and fname.endswith(self._WORK_SUFFIXES)
            )
            if not is_work:
                continue
            path = os.path.join(self.local_repo, fname)
            try:
                if now - os.path.getmtime(path) > min_age_s:
                    os.unlink(path)
                    removed += 1
            except OSError:
                pass  # raced with a concurrent sweep/writer
        return removed

    def _fetch_verified(self, schema: ModelSchema, suffix: str = ".tmp") -> str:
        """Fetch schema.uri into a fresh tmp in the repo and sha256-verify
        it. Returns the tmp path (caller installs/converts then removes).

        Unique tmp per attempt, and the WORKER never touches the install
        destination: a timed-out attempt's abandoned thread can only ever
        finish writing its own orphan tmp (age-swept by sweep_orphan_tmps
        on later fetches) — it cannot install an unverified file behind a
        later sha check."""
        import tempfile

        self.sweep_orphan_tmps()

        # a COMMITTED index must work from any checkout path, so schema.uri
        # may be repo-relative: resolve scheme-less relative uris against
        # the repo directory
        uri = schema.uri
        if "://" not in uri and not os.path.isabs(uri):
            uri = os.path.join(self.local_repo, uri)

        def copy():
            fd, tmp = tempfile.mkstemp(
                prefix=f".{schema.name}.", suffix=suffix,
                dir=self.local_repo,
            )
            os.close(fd)
            try:
                # scheme-dispatched fetch: local, file://, http(s)://, or
                # fsspec-backed cloud stores (utils.storage — the
                # HadoopUtils/remote-repo analogue)
                from ..utils.storage import copy_to_local

                copy_to_local(uri, tmp)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            return tmp

        tmp = retry_with_timeout(copy)
        try:
            if schema.sha256:
                got = _sha256(tmp)
                if got != schema.sha256:
                    raise IOError(
                        f"hash mismatch for {schema.name}: got {got[:12]}…, "
                        f"want {schema.sha256[:12]}…"
                    )
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return tmp

    def _register(self, schema: ModelSchema) -> None:
        schemas = [s for s in self.models() if s.name != schema.name]
        schemas.append(schema)
        self._write_index(schemas)

    def download_model(self, schema: ModelSchema, force: bool = False) -> str:
        """Fetch + verify + register; returns the local bundle path."""
        dest = self.local_path(schema.name)
        if os.path.exists(dest) and not force:
            return dest
        tmp = self._fetch_verified(schema)
        try:
            os.replace(tmp, dest)  # verify-then-install, main thread only
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._register(schema)
        return dest

    def _verify_sha(self, name: str, path: str) -> None:
        """Verify an indexed artifact's committed hash before serving it;
        un-indexed names (ad-hoc files) are served unverified."""
        try:
            schema = self.get_model(name)
        except KeyError:
            return
        if schema.sha256:
            got = _sha256(path)
            if got != schema.sha256:
                raise IOError(
                    f"hash mismatch for {name}: got {got[:12]}…, "
                    f"want {schema.sha256[:12]}…"
                )

    def load_bundle(self, name: str) -> ModelBundle:
        path = self.local_path(name)
        self._verify_sha(name, path)
        return ModelBundle.load(path)

    def import_external(self, schema: ModelSchema, force: bool = False) -> str:
        """Fetch EXTERNAL-format pretrained weights (torch-layout
        `.safetensors`/`.npz` state dict at `schema.uri`), convert them to a
        native ModelBundle, and register the model — the reference's
        remote-repo ingestion of published CNTK models
        (ModelDownloader.scala:209+, Schema.scala:30-119). The artifact is
        sha256-verified BEFORE conversion; the converted bundle is what
        lands in the repo."""
        dest = self.local_path(schema.name)
        if os.path.exists(dest) and not force:
            return dest
        suffix = os.path.splitext(schema.uri)[1] or ".safetensors"
        tmp = self._fetch_verified(schema, suffix=suffix + ".tmp")
        try:
            # the loader dispatches on extension; the verified tmp carries
            # "<ext>.tmp", so hand it over under its real extension
            typed = tmp[: -len(".tmp")]
            os.replace(tmp, typed)
            tmp = typed
            from .import_weights import import_external_weights

            kw = dict(schema.extra.get("config", {}))
            if schema.input_shape:
                kw["input_shape"] = tuple(schema.input_shape)
            bundle = import_external_weights(
                tmp,
                architecture=schema.architecture or "resnet50",
                num_outputs=schema.num_outputs,
                class_labels=schema.class_labels,
                **kw,
            )
            bundle.save(dest)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._register(schema)
        return dest

    # -- publish (the reference's uploader role) ------------------------- #

    def publish(self, bundle: ModelBundle, name: str,
                class_labels: list | None = None,
                relative_uri: bool = False,
                extra: dict | None = None) -> ModelSchema:
        """`relative_uri=True` writes a repo-relative uri so the index can
        be COMMITTED and served from any checkout path (the stocked-zoo
        story, ModelDownloader.scala:209+)."""
        path = self.local_path(name)
        bundle.save(path)
        schema = ModelSchema(
            name=name,
            uri=(os.path.basename(path) if relative_uri
                 else "file://" + path),
            sha256=_sha256(path),
            architecture=bundle.architecture,
            input_shape=bundle.input_shape,
            num_outputs=bundle.config.get("num_outputs"),
            class_labels=class_labels or bundle.class_labels,
            extra=dict(extra or {}),
        )
        self._register(schema)
        return schema

    # -- GBDT artifacts: the zoo serves boosters too --------------------- #
    # The reference's zoo is CNTK-only because its GBDT rides Spark MLlib
    # persistence; here the booster's LightGBM-format model.txt IS the
    # interchange artifact (docs/scope.md), so the same repo stocks both.

    def publish_booster(self, booster, name: str,
                        extra: dict | None = None) -> ModelSchema:
        path = self.local_path(name)
        txt = booster.to_lightgbm_text()
        with open(path, "w") as fh:
            fh.write(txt)
        schema = ModelSchema(
            name=name, uri=os.path.basename(path), sha256=_sha256(path),
            architecture="gbdt",
            extra={"format": "lightgbm_model_txt", **(extra or {})},
        )
        self._register(schema)
        return schema

    def load_booster(self, name: str, device: str = "cuda"):
        """Load a published GBDT artifact (LightGBM model.txt format —
        `Booster.load_native_model` autodetects) to score on `device`."""
        from ..gbdt.booster import Booster

        schema = self.get_model(name)
        if schema.architecture != "gbdt":
            raise ValueError(
                f"{name!r} is a {schema.architecture!r} bundle, not a "
                "gbdt artifact — use load_bundle"
            )
        path = self.local_path(name)
        self._verify_sha(name, path)
        return Booster.load_native_model(path, device=device)
