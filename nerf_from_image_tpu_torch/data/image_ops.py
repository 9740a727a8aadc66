"""Host-side image utilities for the data layer (numpy).

Mirrors the reference's crop/scale/mirror pipeline helpers (reference:
data/datasets.py:152-243): INTER_AREA resize, padded crop with background
fill, square-bbox expansion, bbox perturbation and the normalized-bbox
computation used by evaluation rendering. This package's copy of the JAX
package's data/image_ops.py, with cv2's INTER_AREA, INTER_LINEAR and
INTER_NEAREST resizes written out in numpy, so the data layer runs
without OpenCV.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def _linear_taps(n_src: int, n_dst: int, area: bool):
    """cv2's two-tap coefficients along one axis (imgproc/src/resize.cpp,
    the generic path): per output index, two source indices and their
    float32 weights. INTER_LINEAR samples at pixel centres; INTER_AREA's
    enlargement keeps each output step inside one source pixel but at its
    far edge."""
    inv_scale = n_dst / n_src
    scale = 1.0 / inv_scale
    d = np.arange(n_dst, dtype=np.float64)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        x = (d + 0.5) * scale - 0.5
        s = np.floor(x).astype(np.int64)
        f = (x - s).astype(np.float32)
    f[(s < 0) | (s >= n_src - 1)] = 0  # the edges repeat their pixel
    s = np.clip(s, 0, n_src - 1)
    return s, np.minimum(s + 1, n_src - 1), np.float32(1) - f, f


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """INTER_AREA's shrink along one axis as a dense [n_dst, n_src] matrix
    of cv2's float32 coverage weights (resize.cpp computeResizeAreaTab): an
    integer factor is a block mean, any other takes fractional edges."""
    scale = 1.0 / (n_dst / n_src)
    w = np.zeros((n_dst, n_src), np.float32)
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_src - fsx1)
        sx2 = min(math.floor(fsx2), n_src - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        w[dx, sx1:sx2] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(fsx2 - sx2, 1.0, cell) / cell)
    return w


def _check_float(img: np.ndarray) -> None:
    if img.dtype.kind != "f":
        raise TypeError(f"the resizes take float images, got {img.dtype}")


def _resize(img: np.ndarray, hw: Tuple[int, int], area: bool) -> np.ndarray:
    """cv2.resize of an [H, W] or [H, W, C] float image to hw = (h, w)
    with INTER_AREA (`area`) or INTER_LINEAR: rows, then columns, in
    float64 from cv2's float32 coefficients, cast back to the input's
    dtype. A 1-channel image keeps its channel axis."""
    _check_float(img)
    (h, w), (H, W) = hw, img.shape[:2]
    x = np.asarray(img, np.float64).reshape(H, W, -1)
    if area and h <= H and w <= W:
        x = np.einsum("xw,hwc->hxc", _area_weights(W, w).astype(np.float64), x)
        x = np.einsum("yh,hxc->yxc", _area_weights(H, h).astype(np.float64), x)
    else:
        # Enlarging (or one axis each way): two taps, cv2's "area mode"
        # coefficients under INTER_AREA.
        s0, s1, w0, w1 = _linear_taps(W, w, area)
        x = x[:, s0] * w0[None, :, None] + x[:, s1] * w1[None, :, None]
        s0, s1, w0, w1 = _linear_taps(H, h, area)
        x = x[s0] * w0[:, None, None] + x[s1] * w1[:, None, None]
    return x.reshape((h, w) + img.shape[2:]).astype(img.dtype)


def resize_area(img: np.ndarray, scale_factor: float):
    """cv2.INTER_AREA resize by a scale factor; returns (img, [sy, sx])."""
    new_size = np.round(np.array(img.shape[:2]) * scale_factor).astype(int)
    out = _resize(img, (int(new_size[0]), int(new_size[1])), area=True)
    actual = [new_size[0] / img.shape[0], new_size[1] / img.shape[1]]
    return out, actual


def resize_to(img: np.ndarray, hw: Tuple[int, int], area: bool = True):
    """Resize to hw = (h, w): cv2.INTER_AREA, or INTER_LINEAR for
    area=False."""
    return _resize(img, hw, area)


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_NEAREST resize to hw = (h, w): output pixel i takes source
    pixel floor(i * src/dst) (not the nearest centre), as cv2 does."""
    def index(n_src, n_dst):
        step = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * step).astype(np.int64), n_src - 1)

    return img[index(img.shape[0], hw[0])][:, index(img.shape[1], hw[1])]


def avg_pool2(img: np.ndarray) -> np.ndarray:
    """2x average pool on [H, W, C] (anti-alias after highres augment)."""
    h, w = img.shape[:2]
    return img[: h // 2 * 2, : w // 2 * 2].reshape(
        h // 2, 2, w // 2, 2, -1
    ).mean(axis=(1, 3))


def perturb_bbox(bbox, pf: float = 0.0, jf: float = 0.0, rng=None):
    """Pads (pf) and jitters (jf) a [x1, y1, x2, y2] bbox (reference:
    data/datasets.py:168-183)."""
    out = [float(c) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1

    def j():
        return (1 - 2 * rng.random()) * jf if (rng is not None and jf) else 0.0

    out[0] -= pf * bw + j() * bw
    out[1] -= pf * bh + j() * bh
    out[2] += pf * bw + j() * bw
    out[3] += pf * bh + j() * bh
    return out


def square_bbox(bbox):
    """Expands a bbox to a square, centered (reference:
    data/datasets.py:185-200)."""
    sq = [int(round(c)) for c in bbox]
    bw = sq[2] - sq[0] + 1
    bh = sq[3] - sq[1] + 1
    maxdim = float(max(bw, bh))
    dw2 = int(round((maxdim - bw) / 2.0))
    dh2 = int(round((maxdim - bh) / 2.0))
    sq[0] -= dw2
    sq[1] -= dh2
    sq[2] = int(sq[0] + maxdim - 1)
    sq[3] = int(sq[1] + maxdim - 1)
    return sq


def crop_padded(img: np.ndarray, bbox, bgval: float = 0.0) -> np.ndarray:
    """Crops with out-of-image regions filled with bgval (reference:
    data/datasets.py:202-227)."""
    bbox = [int(round(c)) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    im_h, im_w = img.shape[:2]
    nc = 1 if img.ndim < 3 else img.shape[2]
    if img.ndim < 3:
        img = img[..., None]
    out = np.full((bh, bw, nc), bgval, img.dtype)
    x0s, x1s = max(0, bbox[0]), min(im_w, bbox[2] + 1)
    y0s, y1s = max(0, bbox[1]), min(im_h, bbox[3] + 1)
    x0t = x0s - bbox[0]
    y0t = y0s - bbox[1]
    out[y0t : y0t + (y1s - y0s), x0t : x0t + (x1s - x0s)] = img[
        y0s:y1s, x0s:x1s
    ]
    return out


def normalized_bbox(bbox, im_h: int, im_w: int) -> np.ndarray:
    """Square crop bbox -> normalized render bbox [2, 2] (origin, size),
    y-flipped to the renderer's convention (reference:
    data/datasets.py:300-322)."""
    max_res = max(im_h, im_w)
    bbox_scaled = list(bbox)
    if im_h < im_w:
        bbox_scaled[1] += (max_res - im_h) / 2
    else:
        bbox_scaled[0] += (max_res - im_w) / 2
    start = np.array([bbox_scaled[0], bbox_scaled[1]]) / max_res
    rng_wh = np.array([bbox[2] - bbox[0] + 1, bbox[3] - bbox[1] + 1])
    assert rng_wh[0] == rng_wh[1], "crop must be square"
    rng_wh = rng_wh / max_res
    start = np.array([start[0], 1 - start[1] - rng_wh[1]]) * 2 - 1
    rng_wh = rng_wh * 2
    return np.stack((start, rng_wh), axis=0)


def mirror_bbox(bbox, im_w: int):
    bbox = list(bbox)
    bbox[0], bbox[2] = im_w - bbox[2], im_w - bbox[0]
    return bbox
