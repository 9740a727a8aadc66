"""KITTI/Waymo devkit geometry + visualization helpers.

Completes the devkit surface beyond what the eval pipelines consume
(reference: data/kitti_util.py:328-776, data/kitti_object.py:186-735,
data/waymo_object.py — the waymo devkit is a KITTI-format clone, so one
module serves both). Everything here is host-side numpy: these are data
inspection / authoring tools, not compute-path code, and the reference
keeps them on the host too. All array-level routines are vectorized
(the reference rasterizes its BEV with a triple Python loop,
kitti_util.py:427-527; here it is one grouped scatter with identical
output, golden-tested in tests/test_driving.py::TestDevkit). This
package's copy of the JAX package's data/devkit.py: lines are drawn by its
numpy rasterizer alone (the JAX package's fallback when cv2 is missing)
and KITTI depth PNGs are decoded by utils/images.py. The reference's
mayavi 3D point-cloud viewers (show_lidar_with_boxes etc.,
kitti_object.py:373-735) have no analog here: mayavi is not available in
any supported environment, and the BEV/image-plane views below cover the
same inspection tasks (the JAX package's PARITY.md §2.7).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from nerf_from_image_tpu_torch.data.driving import (  # noqa: F401  (re-export)
    KittiCalibration,
    KittiLabel,
    lidar_in_image_fov,
)
from nerf_from_image_tpu_torch.utils.images import read_png

# BEV raster extents (reference kitti_util.py:14-23).
TOP_X_MIN, TOP_X_MAX, TOP_X_DIVISION = 0.0, 100.0, 0.2
TOP_Y_MIN, TOP_Y_MAX, TOP_Y_DIVISION = -30.0, 30.0, 0.2
TOP_Z_MIN, TOP_Z_MAX, TOP_Z_DIVISION = -3.5, 0.6, 0.3


# --------------------------------------------------------------------------
# Rigid-transform utilities (reference kitti_util.py:336-372)
# --------------------------------------------------------------------------


def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def transform_from_rot_trans(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """[R|t] as a 4x4 homogeneous matrix."""
    out = np.eye(4)
    out[:3, :3] = np.reshape(R, (3, 3))
    out[:3, 3] = np.reshape(t, 3)
    return out


def inverse_rigid_trans(Tr: np.ndarray) -> np.ndarray:
    """Inverts a [3,4] rigid transform: [R'| -R't]."""
    inv = np.zeros_like(Tr)
    inv[:3, :3] = Tr[:3, :3].T
    inv[:3, 3] = -Tr[:3, :3].T @ Tr[:3, 3]
    return inv


# --------------------------------------------------------------------------
# 3D box geometry (reference kitti_util.py:578-666)
# --------------------------------------------------------------------------


def project_to_image(pts_3d: np.ndarray, P: np.ndarray) -> np.ndarray:
    """[N,3] rect-frame points through a [3,4] projection -> [N,2]."""
    p = np.hstack([pts_3d, np.ones((pts_3d.shape[0], 1))]) @ P.T
    return p[:, :2] / p[:, 2:3]


def compute_box_3d(
    obj: KittiLabel, P: np.ndarray
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """KITTI label -> 3D box corners and their image projection.

    Returns (corners_2d [8,2] or None if any corner is behind the camera,
    corners_3d [8,3] in the rect frame). Corner order matches the devkit
    convention (reference kitti_util.py:601-637): bottom face first
    (y=0 at the box base), +x = length (heading), +z = width.
    """
    l, w, h = obj.l, obj.w, obj.h
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    y = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    corners = roty(obj.ry) @ np.stack([x, y, z]) + np.asarray(obj.t)[:, None]
    corners_3d = corners.T
    if np.any(corners_3d[:, 2] < 0.1):
        return None, corners_3d
    return project_to_image(corners_3d, P), corners_3d


def compute_orientation_3d(
    obj: KittiLabel, P: np.ndarray
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Heading vector (box center -> +length) in 3D and image coords
    (reference kitti_util.py:639-666)."""
    ends = roty(obj.ry) @ np.array([[0.0, obj.l], [0, 0], [0, 0]])
    ends = (ends + np.asarray(obj.t)[:, None]).T
    if np.any(ends[:, 2] < 0.1):
        return None, ends
    return project_to_image(ends, P), ends


def box3d_min_max(box3d: np.ndarray) -> Tuple[float, ...]:
    """AABB of an [8,3] corner set (reference kitti_object.py:635-639)."""
    mins = np.min(box3d, axis=0)
    maxs = np.max(box3d, axis=0)
    return (mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2])


def velo_points_in_box3d(
    pc_velo: np.ndarray, box3d_velo: np.ndarray
) -> np.ndarray:
    """AABB-filter of velo points against an [8,3] velo-frame box
    (reference kitti_object.py:641-657 get_velo_whl's selection)."""
    xmin, xmax, ymin, ymax, zmin, zmax = box3d_min_max(box3d_velo)
    m = (
        (pc_velo[:, 0] >= xmin) & (pc_velo[:, 0] <= xmax)
        & (pc_velo[:, 1] >= ymin) & (pc_velo[:, 1] <= ymax)
        & (pc_velo[:, 2] >= zmin) & (pc_velo[:, 2] <= zmax)
    )
    return pc_velo[m]


# --------------------------------------------------------------------------
# Depth-map <-> point-list helpers (reference kitti_util.py:328-334,
# kitti_object.py:354-371)
# --------------------------------------------------------------------------


def get_depth_pt3d(depth: np.ndarray) -> np.ndarray:
    """Dense [H,W] depth -> [H*W,3] rows of (row, col, depth)."""
    ii, jj = np.meshgrid(
        np.arange(depth.shape[0]), np.arange(depth.shape[1]), indexing="ij"
    )
    return np.stack([ii.ravel(), jj.ravel(), depth.ravel()], axis=1)


def depth_region_pt3d(depth: np.ndarray, obj: KittiLabel) -> np.ndarray:
    """(row, col, depth) rows inside a label's 2D box (reference
    kitti_object.py:354-363 — note its column-major iteration order)."""
    x0, y0, x1, y1 = (int(v) for v in obj.box2d)
    cols, rows = np.meshgrid(
        np.arange(x0, x1), np.arange(y0, y1), indexing="ij"
    )
    return np.stack(
        [rows.ravel(), cols.ravel(), depth[rows.ravel(), cols.ravel()]],
        axis=1,
    )


def load_velo_scan(path: str, dtype=np.float32, n_vec: int = 4) -> np.ndarray:
    return np.fromfile(path, dtype=dtype).reshape(-1, n_vec)


def load_depth_png(path: str) -> np.ndarray:
    """KITTI uint16 depth png -> float meters (value/256, reference
    kitti_util.py:391-409)."""
    return read_png(path).astype(np.float64) / 256.0


# --------------------------------------------------------------------------
# BEV (top-view) raster (reference kitti_util.py:417-527)
# --------------------------------------------------------------------------


def lidar_to_top_coords(x: float, y: float) -> Tuple[int, int]:
    """velo (x, y) -> BEV image (col, row) (reference kitti_util.py:417)."""
    Xn = int((TOP_X_MAX - TOP_X_MIN) // TOP_X_DIVISION) + 1
    Yn = int((TOP_Y_MAX - TOP_Y_MIN) // TOP_Y_DIVISION) + 1
    xx = Yn - int((y - TOP_Y_MIN) // TOP_Y_DIVISION)
    yy = Xn - int((x - TOP_X_MIN) // TOP_X_DIVISION)
    return xx, yy


def lidar_to_top(lidar: np.ndarray) -> np.ndarray:
    """Rasterizes a velo point cloud into the devkit's BEV feature volume.

    Output [H, W, Zn+2]: per-z-slice max height-above-slice, then the
    reflectance of each cell's highest point, then log-scaled density.
    Semantics (including the devkit's negative-index cell addressing)
    match reference kitti_util.py:427-527 exactly — golden-tested — but
    the triple Python loop over cells is replaced by one lexsort +
    grouped-scatter pass.

    Documented edge-case divergence: for the reflectance channel the
    devkit's np.argmax picks the FIRST point (original scan order) among
    cell-mates sharing the exact same max height, while the lexsort-last
    pass here picks the LAST. Exact float ties between distinct returns
    are measure-zero for real LiDAR data, so the golden test holds on
    generic inputs; duplicated returns could differ in that one channel.
    """
    m = (
        (lidar[:, 0] > TOP_X_MIN) & (lidar[:, 0] < TOP_X_MAX)
        & (lidar[:, 1] > TOP_Y_MIN) & (lidar[:, 1] < TOP_Y_MAX)
        & (lidar[:, 2] > TOP_Z_MIN) & (lidar[:, 2] < TOP_Z_MAX)
    )
    pts = lidar[m]
    Xn = int((TOP_X_MAX - TOP_X_MIN) // TOP_X_DIVISION) + 1
    Yn = int((TOP_Y_MAX - TOP_Y_MIN) // TOP_Y_DIVISION) + 1
    Zn = int((TOP_Z_MAX - TOP_Z_MIN) / TOP_Z_DIVISION)
    height, width, channel = Xn, Yn, Zn + 2
    top = np.zeros((height, width, channel), np.float32)
    if pts.shape[0] == 0:
        return top
    qx = ((pts[:, 0] - TOP_X_MIN) // TOP_X_DIVISION).astype(np.int64)
    qy = ((pts[:, 1] - TOP_Y_MIN) // TOP_Y_DIVISION).astype(np.int64)
    qz = (pts[:, 2] - TOP_Z_MIN) / TOP_Z_DIVISION
    refl = pts[:, 3] if pts.shape[1] > 3 else np.zeros(len(pts))
    # The devkit addresses cells with NEGATIVE indices (top[-x, -y]):
    # replicate via modular row/col.
    row = (-qx) % height
    col = (-qy) % width
    cell = row * width + col
    # Density + highest-point reflectance: group points by cell.
    order = np.lexsort((qz, cell))
    cell_s, qz_s, refl_s = cell[order], qz[order], refl[order]
    uniq, start, count = np.unique(
        cell_s, return_index=True, return_counts=True
    )
    last = start + count - 1  # argmax of qz within each cell (sorted)
    r, c = uniq // width, uniq % width
    top[r, c, Zn + 1] = np.minimum(
        1.0, np.log(count + 1) / math.log(32)
    )
    top[r, c, Zn] = refl_s[last]
    # Per-slice max height above the slice floor, over points with
    # qz in [z, z+1] (slices overlap at integers, as in the devkit).
    for z in range(Zn):
        sel = (qz_s >= z) & (qz_s <= z + 1)
        if not np.any(sel):
            continue
        h = np.zeros(height * width, np.float32)
        np.maximum.at(h, cell_s[sel], (qz_s[sel] - z).astype(np.float32))
        hit = np.zeros(height * width, bool)
        hit[cell_s[sel]] = True
        top[..., z] = np.where(
            hit.reshape(height, width), h.reshape(height, width), top[..., z]
        )
    return top


def draw_top_image(lidar_top: np.ndarray) -> np.ndarray:
    """BEV feature volume -> uint8 grayscale RGB (reference
    kitti_util.py:695-701)."""
    img = np.sum(lidar_top, axis=2)
    img = img - np.min(img)
    div = max(np.max(img), 1e-12)
    img = (img / div * 255).astype(np.uint8)
    return np.dstack([img, img, img])


# --------------------------------------------------------------------------
# Drawing (reference kitti_util.py:669-750, kitti_object.py:186-318)
# --------------------------------------------------------------------------


def _draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """An integer line of `thickness` pixels (a square brush), clipped."""
    x0, y0, x1, y1 = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.rint(np.linspace(x0, x1, n + 1)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n + 1)).astype(int)
    r = max(thickness // 2, 0)
    H, W = img.shape[:2]
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            ok = (
                (xs + dx >= 0) & (xs + dx < W)
                & (ys + dy >= 0) & (ys + dy < H)
            )
            img[ys[ok] + dy, xs[ok] + dx] = color


def draw_projected_box3d(
    image: np.ndarray,
    qs: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Draws the 12 edges of a projected 3D box ([8,2] corners, devkit
    corner order; reference kitti_util.py:669-692). In-place on `image`.
    """
    qs = qs.astype(np.int32)
    for k in range(4):
        i, j = k, (k + 1) % 4
        _draw_line(image, qs[i], qs[j], color, thickness)
        _draw_line(image, qs[i + 4], qs[j + 4], color, thickness)
        _draw_line(image, qs[k], qs[k + 4], color, thickness)
    return image


def draw_box3d_on_top(
    image: np.ndarray,
    boxes3d: List[np.ndarray],
    color=(255, 255, 255),
    thickness: int = 1,
) -> np.ndarray:
    """Draws velo-frame box footprints onto a BEV image (reference
    kitti_util.py:704-750, minus its score-heatmap text overlay)."""
    img = image.copy()
    for b in boxes3d:
        uv = [lidar_to_top_coords(b[i, 0], b[i, 1]) for i in range(4)]
        for i in range(4):
            _draw_line(img, uv[i], uv[(i + 1) % 4], color, thickness)
    return img


def show_image_with_boxes(
    img: np.ndarray,
    objects: List[KittiLabel],
    calib: KittiCalibration,
    show3d: bool = True,
) -> np.ndarray:
    """2D-box / projected-3D-box overlay (reference
    kitti_object.py:186-247 show_image_with_boxes, returning instead of
    displaying — environments here are headless)."""
    img = np.ascontiguousarray(img.copy())
    for obj in objects:
        if obj.type == "DontCare":
            continue
        if show3d:
            corners_2d, _ = compute_box_3d(obj, calib.P)
            if corners_2d is not None:
                draw_projected_box3d(img, corners_2d)
        else:
            x0, y0, x1, y1 = (int(v) for v in obj.box2d)
            for p0, p1 in (
                ((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0)),
            ):
                _draw_line(img, p0, p1, (0, 255, 0), 2)
    return img
