"""Image / binary file readers.

A copy of mmlspark_tpu/image/io.py (host numpy code).

Reference: `PatchedImageFileFormat` (src/io/image/src/main/scala/
PatchedImageFileFormat.scala:23-124) and `BinaryFileFormat`
(src/io/binary/src/main/scala/BinaryFileFormat.scala:114-217): Hadoop glob +
recursive listing + sampling + (image) decode into the Spark image schema.
Here: pathlib glob + PIL decode into (H, W, C) uint8 numpy arrays; decode is
host-side exactly like the reference's JVM-side decode (SURVEY.md §2.1
OpenCV row).
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np

from ..core.schema import IMAGE_SPEC, Table

__all__ = ["read_images", "read_binary_files", "write_binary_files",
           "decode_image", "encode_image"]

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".ppm", ".tif", ".tiff"}


def decode_image(data: bytes, resize: tuple[int, int] | None = None) -> np.ndarray:
    """bytes -> (H, W, 3) uint8 RGB (channel order documented on IMAGE_SPEC;
    the reference keeps OpenCV's BGR)."""
    from PIL import Image

    img = Image.open(_io.BytesIO(data)).convert("RGB")
    if resize is not None:
        img = img.resize((resize[1], resize[0]))  # PIL takes (w, h)
    return np.asarray(img, np.uint8)


def encode_image(arr: np.ndarray, format: str = "PNG") -> bytes:
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, format=format)
    return buf.getvalue()


def _list_files(path: str, glob: str | None, recursive: bool) -> list[Path]:
    p = Path(path)
    if p.is_file():
        return [p]
    pattern = glob or "*"
    files = p.rglob(pattern) if recursive else p.glob(pattern)
    return sorted(f for f in files if f.is_file())


def read_binary_files(
    path: str,
    glob: str | None = None,
    recursive: bool = False,
    sample_ratio: float = 1.0,
    seed: int = 0,
) -> Table:
    """Directory -> Table{path, bytes, length} (BinaryFileFormat semantics,
    incl. sampleRatio, BinaryFileFormat.scala:114-217)."""
    files = _list_files(path, glob, recursive)
    if sample_ratio < 1.0:
        rng = np.random.default_rng(seed)
        files = [f for f in files if rng.random() < sample_ratio]
    paths, blobs, lengths = [], [], []
    for f in files:
        data = f.read_bytes()
        paths.append(str(f))
        blobs.append(data)
        lengths.append(len(data))
    return Table({"path": paths, "bytes": blobs,
                  "length": np.asarray(lengths, np.int64)})


def write_binary_files(
    table: Table,
    out_dir: str,
    path_col: str = "path",
    bytes_col: str = "bytes",
    overwrite: bool = False,
    base_dir: str | None = None,
) -> list[str]:
    """Table{path, bytes} -> files under `out_dir` — the write side of the
    binary format (reference `BinaryOutputWriter`,
    BinaryFileFormat.scala:219+: each row's byte payload lands at a path
    derived from its path column).

    Destination mapping: relative paths keep their directory structure
    under `out_dir`. Absolute paths (what `read_binary_files` emits) are
    relativized to `base_dir` when given — the lossless recursive
    roundtrip: `write_binary_files(read_binary_files(d, recursive=True),
    out, base_dir=d)` — and re-rooted by basename otherwise. Duplicate
    destinations (two rows, one target) and traversal outside `out_dir`
    are rejected UP FRONT, before any byte is written, so a bad table
    can't leave a half-written directory. Returns the written file paths,
    in row order."""
    out_root = Path(out_dir).resolve()
    base = Path(base_dir).resolve() if base_dir is not None else None
    paths = table[path_col]
    blobs = table[bytes_col]
    dests: list[Path] = []
    for rel in paths:
        p = Path(str(rel))
        if p.is_absolute():
            if base is not None:
                try:
                    p = p.resolve().relative_to(base)
                except ValueError:
                    raise ValueError(
                        f"path {rel!r} is not under base_dir {base_dir!r}"
                    ) from None
            else:
                p = Path(p.name)
        dest = (out_root / p).resolve()
        if out_root != dest and out_root not in dest.parents:
            raise ValueError(f"path {rel!r} escapes the output directory")
        dests.append(dest)
    dupes = {d for d in dests if dests.count(d) > 1}
    if dupes:
        raise ValueError(
            f"{len(dupes)} destination collision(s) (e.g. "
            f"{sorted(dupes)[0]}): rows map to the same output file — "
            "pass base_dir to preserve source structure"
        )
    if not overwrite:
        existing = [d for d in dests if d.exists()]
        if existing:
            raise FileExistsError(
                f"{existing[0]} exists; pass overwrite=True to replace"
            )
    out_root.mkdir(parents=True, exist_ok=True)
    written: list[str] = []
    for dest, data in zip(dests, blobs):
        dest.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        dest.write_bytes(bytes(data))
        written.append(str(dest))
    return written


def read_images(
    path: str,
    glob: str | None = None,
    recursive: bool = False,
    sample_ratio: float = 1.0,
    drop_invalid: bool = True,
    resize: tuple[int, int] | None = None,
    seed: int = 0,
) -> Table:
    """Directory -> Table{path, image} (PatchedImageFileFormat semantics).

    With `resize`, all images share one shape and the column is a single
    (n, H, W, 3) array (XLA-friendly); otherwise a list of (H, W, 3) arrays.
    """
    files = [
        f for f in _list_files(path, glob, recursive)
        if f.suffix.lower() in _IMAGE_EXTS
    ]
    if sample_ratio < 1.0:
        rng = np.random.default_rng(seed)
        files = [f for f in files if rng.random() < sample_ratio]
    paths, images = [], []
    for f in files:
        try:
            img = decode_image(f.read_bytes(), resize=resize)
        except Exception:
            if drop_invalid:
                continue
            raise
        paths.append(str(f))
        images.append(img)
    col = np.stack(images) if (resize is not None and images) else images
    meta = {}
    if resize is not None:
        meta["image"] = {IMAGE_SPEC: {
            "height": resize[0], "width": resize[1], "channels": 3,
            "channel_order": "RGB",
        }}
    return Table({"path": paths, "image": col}, meta=meta)
