"""Storage abstraction: scheme-dispatched file access.

A copy of mmlspark_tpu/utils/storage.py.

Reference: `core/hadoop/HadoopUtils.scala` + the `org.apache.hadoop.fs`
usage throughout `ModelDownloader.scala:54-119` (remote Azure-blob repo →
local/HDFS repo). TPU-first equivalent: one small URI-dispatch layer —
local paths and `file://` natively, `http(s)://` read-only via urllib,
`gs://`/`s3://` through fsspec when installed (gated, never required) —
so callers (the model zoo, checkpoint paths) never branch on scheme.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import urllib.parse
import urllib.request
from typing import BinaryIO

__all__ = [
    "scheme_of",
    "exists",
    "read_bytes",
    "write_bytes",
    "atomic_write",
    "open_read",
    "copy_to_local",
]

_FSSPEC_SCHEMES = ("gs", "s3", "abfs", "az", "hdfs")


_KNOWN_SCHEMES = ("file", "http", "https") + _FSSPEC_SCHEMES


def scheme_of(uri: str) -> str:
    """'' for local paths; otherwise the lowercase URI scheme. A colon-y
    first path segment that is NOT a known scheme (e.g. 'model:v2.bin') is
    still a local path — the pre-abstraction zoo copied such names with
    shutil and that behavior is preserved."""
    parsed = urllib.parse.urlparse(uri)
    # windows drive letters / bare paths have no netloc and 0-1 char scheme
    if len(parsed.scheme) <= 1:
        return ""
    scheme = parsed.scheme.lower()
    if scheme in _KNOWN_SCHEMES:
        return scheme
    if parsed.netloc:
        return scheme  # URL-shaped but unknown -> callers reject it loudly
    return ""          # colon-y local filename like 'model:v2.bin'


def _local_path(uri: str) -> str:
    if uri.startswith("file://"):
        return urllib.parse.urlparse(uri).path or uri[len("file://"):]
    return uri


def _fsspec_fs(scheme: str):
    try:
        import fsspec  # optional, never a hard dependency
    except ImportError as e:
        raise NotImplementedError(
            f"{scheme}:// access needs fsspec (+ the {scheme} driver) "
            "installed; stage the file locally or serve it over http"
        ) from e
    return fsspec.filesystem(scheme)


def exists(uri: str) -> bool:
    scheme = scheme_of(uri)
    if scheme in ("", "file"):
        return os.path.exists(_local_path(uri))
    if scheme in ("http", "https"):
        req = urllib.request.Request(uri, method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return 200 <= r.status < 300
        except Exception:  # noqa: BLE001 — absent/unreachable both mean "no"
            return False
    if scheme in _FSSPEC_SCHEMES:
        return _fsspec_fs(scheme).exists(uri)
    raise ValueError(f"unsupported storage scheme {scheme!r} in {uri!r}")


def open_read(uri: str) -> BinaryIO:
    scheme = scheme_of(uri)
    if scheme in ("", "file"):
        return open(_local_path(uri), "rb")
    if scheme in ("http", "https"):
        return urllib.request.urlopen(uri, timeout=60)
    if scheme in _FSSPEC_SCHEMES:
        return _fsspec_fs(scheme).open(uri, "rb")
    raise ValueError(f"unsupported storage scheme {scheme!r} in {uri!r}")


def read_bytes(uri: str) -> bytes:
    with open_read(uri) as f:
        return f.read()


def write_bytes(uri: str, data: bytes) -> None:
    scheme = scheme_of(uri)
    if scheme in ("", "file"):
        path = _local_path(uri)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        return
    if scheme in ("http", "https"):
        raise ValueError("http(s) storage is read-only")
    if scheme in _FSSPEC_SCHEMES:
        with _fsspec_fs(scheme).open(uri, "wb") as f:
            f.write(data)
        return
    raise ValueError(f"unsupported storage scheme {scheme!r} in {uri!r}")


def _note_fsync() -> None:
    """Runtime R3 hook: report an fsync issued while the calling thread
    holds a sanitized lock (free when the sanitizer is off)."""
    try:
        from ..observability.sanitizer import note_blocking

        note_blocking("fsync")
    except ImportError:  # partial package import — never block a write
        pass


def _fsync_dir(path: str) -> None:
    """fsync the directory so the rename itself is durable. Some
    filesystems refuse directory fds (or fsync on them) — crash
    consistency degrades gracefully there, it must not break writes."""
    _note_fsync()
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: "bytes | str") -> None:
    """Crash-consistent local write: tmp file in the target directory →
    write → flush → fsync(file) → os.replace → fsync(directory).

    After this returns, a reader sees either the old content or the new
    content, never a torn file — and the new content survives power loss
    (the plain tempfile+os.replace idiom the early writers used leaves
    both the data and the rename in volatile cache). Local paths only:
    checkpoint/journal writers that need durability are all local."""
    if scheme_of(path) not in ("", "file"):
        raise ValueError(f"atomic_write is local-only, got {path!r}")
    dest = _local_path(path)
    payload = data.encode("utf-8") if isinstance(data, str) else data
    dirname = os.path.dirname(dest) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    _note_fsync()
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, dest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(dirname)


def copy_to_local(uri: str, dest_path: str) -> str:
    """Stream any readable URI to a local file (the remote→local repo hop,
    ModelDownloader.scala:54-119)."""
    scheme = scheme_of(uri)
    if scheme in ("", "file"):
        shutil.copyfile(_local_path(uri), dest_path)
        return dest_path
    with open_read(uri) as src, open(dest_path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return dest_path
