"""Model interpretation: superpixels + ImageLIME.

Counterpart of mmlspark_tpu/automl/lime.py. Reference:
src/image-featurizer/ — `Superpixel` (Superpixel.scala:154+, SLIC-style
clustering), `SuperpixelTransformer` (SuperpixelTransformer.scala:33+),
`ImageLIME` (ImageLIME.scala:27+: superpixel perturbation, censored copies
scored through the model, then a per-image local `LinearRegression` fit
:86-120).

SLIC is a fixed-iteration k-means over (y, x, rgb) in torch on `device`
("cuda" by default), every step in float32 as the JAX package's jitted
program: the squared distances summed channel by channel in order, the
assignment `argmin` (the first index among equal distances, as `jnp`'s),
the centre sums a one-hot matrix product (TF32 off). A pixel at equal
distance from two centres is an exact tie, so a different summation order
can flip it: the port and the JAX package agree except at such pixels.
All perturbed copies are scored in batches through the model's own
`transform` (it runs on its own device); the local explanation is the
reference's closed-form ridge, solved on the host in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.kernels import resolve_device
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["superpixels", "slic_distances", "SuperpixelTransformer", "ImageLIME"]


@functools.lru_cache(maxsize=16)
def _slic_grid(h: int, w: int, cell_size: int, compactness: float, device: torch.device):
    """The pixel coordinates scaled into feature space, the initial centre
    positions and the cluster count, as the JAX program builds them."""
    gh = max(h // cell_size, 1)
    gw = max(w // cell_size, 1)
    k = gh * gw
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=device),
                            torch.arange(w, dtype=torch.int32, device=device), indexing="ij")
    spatial_scale = compactness / cell_size
    yx = torch.stack([ys, xs], dim=-1).reshape(-1, 2).to(torch.float32) * spatial_scale
    cy = (torch.arange(gh, dtype=torch.int32, device=device).to(torch.float32) + 0.5) * (h / gh)
    cx = (torch.arange(gw, dtype=torch.int32, device=device).to(torch.float32) + 0.5) * (w / gw)
    c_yx0 = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), dim=-1).reshape(k, 2)
    return yx, c_yx0, k, spatial_scale


def _sq_distances(feat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(HW, K) squared distances, the channels summed in order."""
    d = (feat[:, None, 0] - centers[None, :, 0]) ** 2
    for c in range(1, feat.shape[1]):
        d = d + (feat[:, None, c] - centers[None, :, c]) ** 2
    return d


def _slic_centers(img: torch.Tensor, cell_size: int, iters: int, compactness: float):
    """(feature matrix (HW, 2+C), final centres (K, 2+C), K)."""
    h, w = img.shape[0], img.shape[1]
    yx, c_yx0, k, spatial_scale = _slic_grid(h, w, cell_size, float(compactness), img.device)
    img = img.to(torch.float32)
    if img.shape[-1] > 3:
        img = img[..., :3]
    feat = torch.cat([yx, img.reshape(-1, img.shape[-1])], dim=1)
    iy = c_yx0[:, 0].to(torch.int32).clamp(0, h - 1).long()
    ix = c_yx0[:, 1].to(torch.int32).clamp(0, w - 1).long()
    centers = torch.cat([c_yx0 * spatial_scale, img[iy, ix]], dim=1)
    for _ in range(iters):
        assign = torch.argmin(_sq_distances(feat, centers), dim=1)
        oh = torch.nn.functional.one_hot(assign, k).to(torch.float32)  # (HW, K)
        counts = oh.sum(dim=0)[:, None]
        sums = oh.T @ feat
        new_centers = sums / torch.clamp(counts, min=1.0)
        centers = torch.where(counts > 0, new_centers, centers)
    return feat, centers, k


def superpixels(img: np.ndarray, cell_size: int = 16, iters: int = 5,
                compactness: float = 10.0, device: str = "cuda") -> tuple[np.ndarray, int]:
    """(H, W, C) image -> ((H, W) int32 labels, num_clusters), on `device`."""
    img = np.asarray(img)
    dev = resolve_device(device)
    with torch.no_grad():
        feat, centers, k = _slic_centers(torch.as_tensor(img, device=dev), cell_size, iters,
                                         compactness)
        labels = torch.argmin(_sq_distances(feat, centers), dim=1)
    return labels.reshape(img.shape[0], img.shape[1]).to(torch.int32).cpu().numpy(), k


def slic_distances(img: np.ndarray, cell_size: int = 16, iters: int = 5,
                   compactness: float = 10.0, device: str = "cuda") -> np.ndarray:
    """(H, W, K) float32 squared distances of every pixel to the final
    centres `superpixels` assigns from: a pixel whose two smallest lie
    within a relative 1e-5 is a near-tie, whose label a different
    summation order may flip."""
    img = np.asarray(img)
    dev = resolve_device(device)
    with torch.no_grad():
        feat, centers, k = _slic_centers(torch.as_tensor(img, device=dev), cell_size, iters,
                                         compactness)
        d = _sq_distances(feat, centers)
    return d.reshape(img.shape[0], img.shape[1], k).cpu().numpy()


@register_stage
class SuperpixelTransformer(HasInputCol, HasOutputCol, Transformer):
    """Reference: SuperpixelTransformer.scala:33+."""

    input_col = Param("image", "image column", ptype=str)
    output_col = Param("superpixels", "labels output column", ptype=str)
    cell_size = Param(16, "target superpixel cell size (px)", ptype=int)
    iters = Param(5, "SLIC iterations", ptype=int)
    compactness = Param(10.0, "spatial vs color weight", ptype=float)
    device = Param("cuda", "torch device of the clustering: cuda | cpu", ptype=str)

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        imgs = col if isinstance(col, list) else list(np.asarray(col))
        labels = [
            superpixels(im, self.get("cell_size"), self.get("iters"),
                        self.get("compactness"), device=self.get("device"))[0]
            for im in imgs
        ]
        out = np.stack(labels) if len({l.shape for l in labels}) == 1 else labels
        return table.with_column(self.get("output_col"), out)


@register_stage
class ImageLIME(HasInputCol, HasOutputCol, Transformer):
    """Local linear explanation of an image model
    (reference ImageLIME.scala:27-120)."""

    model = Param(None, "fitted Transformer scoring the image column", required=True)
    input_col = Param("image", "image column", ptype=str)
    output_col = Param("weights", "per-superpixel importance column", ptype=str)
    superpixel_col = Param("superpixels", "emitted superpixel labels column", ptype=str)
    prediction_col = Param("probability", "model output column to explain", ptype=str)
    target_class = Param(None, "class index to explain (default: argmax)", ptype=int)
    num_samples = Param(300, "perturbed copies per image", ptype=int)
    sampling_fraction = Param(0.7, "P(keep superpixel)", ptype=float)
    regularization = Param(1e-3, "ridge lambda", ptype=float)
    cell_size = Param(16, "superpixel cell size", ptype=int)
    fill_value = Param(0.0, "censored-pixel fill value", ptype=float)
    seed = Param(0, "mask sampling seed", ptype=int)
    device = Param("cuda", "torch device of the superpixel clustering: cuda | cpu",
                   ptype=str)

    def _save_state(self):
        return {"model": self.get("model")}

    def _load_state(self, state):
        self.set(model=state["model"])

    def params_to_dict(self):
        d = dict(self._values)
        d.pop("model", None)
        return d

    def _transform(self, table: Table) -> Table:
        model: Transformer = self.get("model")
        col = table[self.get("input_col")]
        imgs = col if isinstance(col, list) else list(np.asarray(col))
        s = int(self.get("num_samples"))
        p_keep = float(self.get("sampling_fraction"))
        lam = float(self.get("regularization"))
        rng = np.random.default_rng(self.get("seed"))

        all_weights, all_labels = [], []
        for im in imgs:
            im = np.asarray(im, np.float32)
            labels, k = superpixels(im, self.get("cell_size"), device=self.get("device"))
            masks = (rng.random((s, k)) < p_keep).astype(np.float32)
            masks[0] = 1.0  # include the unperturbed image
            pixel_mask = masks[:, labels.reshape(-1)].reshape(s, *labels.shape)
            perturbed = im[None] * pixel_mask[..., None] + self.get("fill_value") * (
                1.0 - pixel_mask[..., None]
            )
            scored = model.transform(Table({self.get("input_col"): perturbed}))
            y = np.asarray(scored[self.get("prediction_col")], np.float64)
            if y.ndim == 2:
                tc = self.get("target_class")
                if tc is None:
                    tc = int(np.argmax(y[0]))
                y = y[:, tc]
            # closed-form ridge: w = (X'X + λI)^-1 X'y  (X centered)
            x = masks - masks.mean(axis=0, keepdims=True)
            yc = y - y.mean()
            xtx = x.T @ x + lam * np.eye(k)
            w = np.linalg.solve(xtx, x.T @ yc)
            all_weights.append(w)
            all_labels.append(labels)
        lab_col = (
            np.stack(all_labels) if len({l.shape for l in all_labels}) == 1
            else all_labels
        )
        return table.with_column(
            self.get("output_col"), [w for w in all_weights]
        ).with_column(self.get("superpixel_col"), lab_col)
