"""Host-side image utilities for the data layer (numpy/cv2).

Mirrors the reference's crop/scale/mirror pipeline helpers (reference:
data/datasets.py:152-243): INTER_AREA resize, padded crop with background
fill, square-bbox expansion, bbox perturbation and the normalized-bbox
computation used by evaluation rendering. This package's copy of the JAX
package's data/image_ops.py; cv2 is imported by the resizes alone.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def resize_area(img: np.ndarray, scale_factor: float):
    """cv2.INTER_AREA resize by a scale factor; returns (img, [sy, sx])."""
    import cv2

    new_size = np.round(np.array(img.shape[:2]) * scale_factor).astype(int)
    out = cv2.resize(
        img, (new_size[1], new_size[0]), interpolation=cv2.INTER_AREA
    )
    if out.ndim == 2 and img.ndim == 3:
        out = out[..., None]
    actual = [new_size[0] / img.shape[0], new_size[1] / img.shape[1]]
    return out, actual


def resize_to(img: np.ndarray, hw: Tuple[int, int], area: bool = True):
    import cv2

    interp = cv2.INTER_AREA if area else cv2.INTER_LINEAR
    out = cv2.resize(img, (hw[1], hw[0]), interpolation=interp)
    if out.ndim == 2 and img.ndim == 3:
        out = out[..., None]
    return out


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
