"""Batched PnP on the device: coordinate maps + masks -> camera poses.

Counterpart of nerf_from_image_tpu/pose/pnp.py (all of it but the OpenCV
oracle, which stays with the JAX package's tests). One batched program
over [B samples, K focal guesses, N points]:

  weighted DLT (12x12 eigenproblem) -> polar orthogonalization (matmul-only
  Newton) -> damped Gauss-Newton reprojection refine,

then the best (err, tz > 0) guess per sample; degenerate masks (< 4
points) and diverged solves fall back to the dummy pose (z = -10, focal =
1, err = 10). Pixels map to screen coordinates (i/W, j/H) - 0.5 with
intrinsics diag(f, f, 1); the solved world2cam is pre-multiplied by
diag(1, -1, -1) ("flipped camera").

Where the JAX package relies on XLA's semantics the port keeps them: the
Gauss-Newton solve does not check for a singular system (a NaN reaches
the isfinite guards and selects the dummy pose, as there), and the
foreground compaction breaks ties between equal weights in ascending
index order, as jax.lax.top_k does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.pose.pose import invert_space


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    k = rvec / torch.clamp_min(theta, 1e-12)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zero, -kz, ky], -1),
            torch.stack([kz, zero, -kx], -1),
            torch.stack([-ky, kx, zero], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    th = theta[..., None]
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def polar_orthogonalize(a: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Nearest rotation to 3x3 matrices [..., 3, 3] by the inverse-free
    Newton iteration (matmuls only), scaled first by sqrt(|a|_1 |a|_inf)
    (matrix norms)."""
    norm = torch.sqrt(
        torch.linalg.matrix_norm(a, ord=1) * torch.linalg.matrix_norm(a, ord=float("inf"))
    )
    x = a / torch.clamp_min(norm[..., None, None], 1e-12)
    eye3 = 3.0 * torch.eye(3, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        x = 0.5 * x @ (eye3 - x.transpose(-2, -1) @ x)
    return x


def _dlt_pose(pts: torch.Tensor, uv: torch.Tensor, w: torch.Tensor):
    """Weighted DLT for P = [R | t] from normalized correspondences.

    pts [..., N, 3] world points; uv [..., N, 2] focal-normalized screen
    coordinates; w [..., N] weights. Returns (R_raw [..., 3, 3], t [..., 3]).
    """
    X = torch.cat((pts, torch.ones_like(pts[..., :1])), dim=-1)  # [..., N, 4]
    zeros = torch.zeros_like(X)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    row_u = torch.cat((X, zeros, -u * X), dim=-1)  # [..., N, 12]
    row_v = torch.cat((zeros, X, -v * X), dim=-1)
    A = torch.cat((row_u * w[..., None], row_v * w[..., None]), dim=-2)
    M = A.transpose(-2, -1) @ A  # [..., 12, 12]
    # A non-finite system yields NaN vectors, as jnp.linalg.eigh does, on
    # every backend (LAPACK and cuSOLVER would return or raise otherwise).
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)[..., None, None]
    _, evecs = torch.linalg.eigh(torch.where(finite, M, torch.eye(12, dtype=M.dtype,
                                                                   device=M.device)))
    evecs = torch.where(finite, evecs, torch.nan)
    p = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 4))

    # Fix the scale by the rotation part's third row, the sign by the
    # weighted mean depth.
    scale = torch.linalg.vector_norm(p[..., 2, :3], dim=-1)
    p = p / torch.clamp_min(scale, 1e-12)[..., None, None]
    z = torch.sum(X * p[..., None, 2, :], dim=-1)  # depths [..., N]
    sign = torch.where(torch.sum(z * w, dim=-1) < 0, -1.0, 1.0)
    p = p * sign[..., None, None]
    return p[..., :, :3], p[..., :, 3]


def _camera_points(R, t, pts):
    """R pts + t: [..., N, 3]."""
    return pts @ R.transpose(-2, -1) + t[..., None, :]


def _reproject_residual(R, t, pts, uv, w):
    cam = _camera_points(R, t, pts)
    z = cam[..., 2:3]
    proj = cam[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return (proj - uv) * w[..., None]


def _cross_jac(c: torch.Tensor) -> torch.Tensor:
    """-[c]_x, the Jacobian d(omega x c)/d omega: [..., N, 3, 3]."""
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    zero = torch.zeros_like(cx)
    return torch.stack(
        [
            torch.stack([zero, cz, -cy], -1),
            torch.stack([-cz, zero, cx], -1),
            torch.stack([cy, -cx, zero], -1),
        ],
        -2,
    )


def _gauss_newton_refine(R, t, pts, uv, w, iters: int = 20, damping: float = 1e-6):
    """Damped Gauss-Newton on (so(3) increment, t) minimizing the weighted
    reprojection error in normalized coordinates. The 6x6 solve reports no
    error: a singular system gives non-finite poses, which the callers'
    isfinite guards turn into the dummy pose."""
    eye6 = damping * torch.eye(6, dtype=pts.dtype, device=pts.device)
    w2 = torch.repeat_interleave(w, 2, dim=-1)[..., None]  # [..., 2N, 1]
    for _ in range(iters):
        cam = _camera_points(R, t, pts)
        x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
        z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        inv_z = 1.0 / z
        u = x * inv_z
        v = y * inv_z
        r = torch.stack((u - uv[..., 0], v - uv[..., 1]), -1) * w[..., None]

        # d(u, v)/d(camera point).
        zero = torch.zeros_like(z)
        du = torch.stack((inv_z, zero, -x * inv_z**2), -1)
        dv = torch.stack((zero, inv_z, -y * inv_z**2), -1)
        # The update is R <- rodrigues(omega) @ R with t unrotated, so the
        # rotation Jacobian acts on R p = cam - t.
        dcam_domega = _cross_jac(cam - t[..., None, :])
        Ju_omega = torch.sum(du[..., :, None] * dcam_domega, dim=-2)
        Jv_omega = torch.sum(dv[..., :, None] * dcam_domega, dim=-2)
        Ju = torch.cat((Ju_omega, du), -1)  # [..., N, 6]
        Jv = torch.cat((Jv_omega, dv), -1)
        # Rows interleaved (u, v) per point, as the residual.
        J = torch.stack((Ju, Jv), -2).reshape(Ju.shape[:-2] + (-1, 6)) * w2
        r_flat = r.reshape(r.shape[:-2] + (-1, 1))

        Jt = J.transpose(-2, -1)
        H = Jt @ J + eye6
        g = Jt @ r_flat
        delta, _ = torch.linalg.solve_ex(H, g, check_errors=False)
        delta = delta[..., 0]
        omega, dt = -delta[..., :3], -delta[..., 3:]
        R = rodrigues(omega) @ R
        t = t + dt
    return R, t


def _mean_reproj_error(R, t, pts, uv, w, focal):
    """RMS reprojection error in pixels of the focal-scaled image over the
    weighted points. `focal` is a scalar, or broadcasts against the
    residual's [..., N, 2] (per-axis focals for anisotropic intrinsics)."""
    r = _reproject_residual(R, t, pts, uv, w) * focal
    n = torch.clamp_min(torch.sum(w, dim=-1), 1.0)
    return torch.sqrt(torch.sum(torch.square(r), dim=(-2, -1)) / n)


def _solve_single_focal(pts, uv_pix, w, focal):
    """One PnP solve per leading index: pts [..., N, 3], uv_pix [..., N, 2],
    w [..., N], focal [...]. Returns (R [..., 3, 3], t [..., 3], err [...])."""
    f = focal[..., None, None]
    uv = uv_pix / f
    R_raw, t = _dlt_pose(pts, uv, w)
    R = polar_orthogonalize(R_raw)
    R, t = _gauss_newton_refine(R, t, pts, uv, w)
    err = _mean_reproj_error(R, t, pts, uv, w, f)
    return R, t, err


def _bit_reversal_permutation(n: int) -> np.ndarray:
    """Deterministic spatially stratified order of n row indices.

    Bit-reversing the linear pixel index is a van-der-Corput-style
    low-discrepancy order: any prefix of it covers the whole index range
    (the whole image, for row-major pixel grids) near-uniformly. For n not
    a power of two the reversed values are ranked by a stable argsort."""
    bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(bits - 1 - b)
    if (1 << bits) == n:
        return rev.astype(np.int64)
    return np.argsort(rev, kind="stable").astype(np.int64)


def _compact_foreground(pts, uv_pix, w, max_points: Optional[int]):
    """Keeps (up to) `max_points` rows per sample, foreground first, before
    the solves' matmuls.

    Rows are reordered by the fixed bit-reversal permutation, then the
    `max_points` largest weights are taken in a stable descending sort:
    equal weights keep ascending index order, which is how
    jax.lax.top_k breaks ties (torch.topk promises no order). A mask
    that fits the budget gives the uncompacted solve; an oversized one
    keeps the first foreground rows in the stratified order, which cover
    the whole object."""
    if max_points is None or max_points >= pts.shape[1]:
        return pts, uv_pix, w
    perm = torch.from_numpy(_bit_reversal_permutation(pts.shape[1])).to(pts.device)
    pts = pts[:, perm]
    uv_pix = uv_pix[:, perm]
    w = w[:, perm]
    sel = torch.sort(w, dim=1, descending=True, stable=True).indices[:, :max_points]
    pts = torch.take_along_dim(pts, sel[..., None], dim=1)
    uv_pix = torch.take_along_dim(uv_pix, sel[..., None], dim=1)
    w = torch.take_along_dim(w, sel, dim=1)
    return pts, uv_pix, w


def _screen_grid(B, H, W, dtype, device):
    """Pixel screen coordinates (i/W - 0.5, j/H - 0.5), row-major: [B, H*W, 2]."""
    ii = torch.arange(W, dtype=dtype, device=device)[None, :] / W
    jj = torch.arange(H, dtype=dtype, device=device)[:, None] / H
    gx = torch.broadcast_to(ii, (H, W)) - 0.5
    gy = torch.broadcast_to(jj, (H, W)) - 0.5
    return torch.stack((gx, gy), -1).reshape(1, -1, 2).expand(B, H * W, 2)


def _flipped_world2cam(R, t):
    """[B, 4, 4] diag(1, -1, -1, 1) @ [R | t]."""
    B = R.shape[0]
    m = torch.eye(4, dtype=R.dtype, device=R.device).repeat(B, 1, 1)
    m[:, :3, :3] = R
    m[:, :3, 3] = t
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=R.dtype, device=R.device)
    return flip[None, :, None] * m


def _dummy_select(ok, R, t):
    """Where `ok` [B] is false: the dummy pose (R = I, t = (0, 0, -10))."""
    R_dummy = torch.eye(3, dtype=R.dtype, device=R.device)
    t_dummy = torch.tensor([0.0, 0.0, -10.0], dtype=t.dtype, device=t.device)
    return (torch.where(ok[:, None, None], R, R_dummy),
            torch.where(ok[:, None], t, t_dummy))


def compute_pose_pnp(
    coords: torch.Tensor,
    masks: torch.Tensor,
    focal_guesses,
    max_points: Optional[int] = 8192,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched PnP over a grid coordinate map.

    Args:
      coords: [B, H, W, 3] predicted canonical (world) coordinates.
      masks: [B, H, W] boolean or {0, 1} foreground mask.
      focal_guesses: [K] candidate focal lengths (sequence, array or tensor).
      max_points: the foreground-compaction budget (_compact_foreground);
        None disables compaction.

    Returns:
      (world2cam [B, 4, 4], flipped-camera convention; focal [B]; err [B]),
      on coords' device.
    """
    B, H, W, _ = coords.shape
    dt, dev = coords.dtype, coords.device
    uv_pix = _screen_grid(B, H, W, dt, dev)
    pts = coords.reshape(B, -1, 3)
    w = masks.reshape(B, -1).to(dt)
    pts, uv_pix, w = _compact_foreground(pts, uv_pix, w, max_points)

    if isinstance(focal_guesses, torch.Tensor):
        focals = focal_guesses.to(dtype=dt, device=dev)
    else:
        focals = torch.as_tensor(np.asarray(focal_guesses), dtype=dt).to(dev)
    K = focals.shape[0]
    N = pts.shape[1]
    R_all, t_all, err_all = _solve_single_focal(
        pts[:, None].expand(B, K, N, 3),
        uv_pix[:, None].expand(B, K, N, 2),
        w[:, None].expand(B, K, N),
        focals[None].expand(B, K),
    )
    # A guess whose Gauss-Newton diverged (NaN error) must not win the
    # argmin over a converged guess.
    valid = (t_all[..., 2] > 0) & torch.isfinite(err_all)
    err_masked = torch.where(valid, err_all, torch.inf)
    best = torch.argmin(err_masked, dim=1)  # the first minimum, as jnp.argmin
    any_valid = torch.any(valid, dim=1) & (torch.sum(w, dim=1) >= 4)

    rows = torch.arange(B, device=dev)
    R_out, t_out = _dummy_select(any_valid, R_all[rows, best], t_all[rows, best])
    f_out = torch.where(any_valid, focals[best], 1.0)
    e_out = torch.where(any_valid, err_masked[rows, best], 10.0)
    return _flipped_world2cam(R_out, t_out), f_out, e_out


def compute_pose_pnp_known_k(
    coords: torch.Tensor,
    masks: torch.Tensor,
    intrinsics: torch.Tensor,
    max_points: Optional[int] = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PnP with known per-sample intrinsics (the driving evals).

    Args:
      coords: [B, H, W, 3]; masks: [B, H, W] in [0, 1] (threshold 0.9);
      intrinsics: [B, 3, 3] normalized to the crop (focal and principal
        point in the (i/W - 0.5, j/H - 0.5) screen units).
      max_points: the foreground-compaction budget.
    Returns:
      (world2cam [B, 4, 4], flipped-camera convention; err [B]).
    """
    B, H, W, _ = coords.shape
    dt = coords.dtype
    uv_pix = _screen_grid(B, H, W, dt, coords.device)
    pts = coords.reshape(B, -1, 3)
    w = (masks.reshape(B, -1) > 0.9).to(dt)
    pts, uv_pix, w = _compact_foreground(pts, uv_pix, w, max_points)

    intrinsics = intrinsics.to(dt)
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    uv_norm = torch.stack(
        ((uv_pix[..., 0] - cx[:, None]) / fx[:, None],
         (uv_pix[..., 1] - cy[:, None]) / fy[:, None]), -1
    )
    R_raw, t = _dlt_pose(pts, uv_norm, w)
    R = polar_orthogonalize(R_raw)
    R, t = _gauss_newton_refine(R, t, pts, uv_norm, w)
    err = _mean_reproj_error(R, t, pts, uv_norm, w,
                             torch.stack((fx, fy), -1)[:, None, :])

    # A diverged Gauss-Newton (inf t, NaN residual) falls through to the
    # dummy pose.
    ok = (t[:, 2] > 0) & (torch.sum(w, dim=1) >= 4) & torch.isfinite(err)
    R_out, t_out = _dummy_select(ok, R, t)
    e_out = torch.where(ok, err, 10.0)
    return _flipped_world2cam(R_out, t_out), e_out


def estimate_poses_batch(
    coords: torch.Tensor,
    masks: torch.Tensor,
    focal_guesses: Optional[np.ndarray],
):
    """Encoder outputs -> (cam2world [B, 4, 4], focal [B] or None, err [B]).

    masks [B, H, W] in [0, 1] are thresholded at 0.9. Orthographic datasets
    (focal_guesses None) solve with one large focal (100) and convert back
    to the scaled orthographic camera.
    """
    masks_bin = masks > 0.9
    is_ortho = focal_guesses is None
    guesses = np.asarray([100.0]) if is_ortho else np.asarray(focal_guesses)

    world2cam, focal, errors = compute_pose_pnp(coords, masks_bin, guesses)

    if is_ortho:
        s = 2.0 * float(guesses[0]) / -world2cam[:, 2, 3]
        world2cam = world2cam.clone()
        world2cam[:, :2, 3] = world2cam[:, :2, 3] * s[:, None]
        world2cam[:, 2, 3] = -10.0

    cam2world = invert_space(world2cam)
    if is_ortho:
        return cam2world / s[:, None, None], None, errors
    return cam2world, focal, errors


def get_focal_guesses(focal_length) -> Optional[np.ndarray]:
    """The 1st, 10th, ..., 90th and 99th percentiles of the train-set
    focals (unique values), or None for orthographic datasets."""
    if focal_length is None:
        return None
    sorted_focals = np.sort(np.asarray(focal_length))
    guesses = np.percentile(
        sorted_focals, [1, 10, 20, 30, 40, 50, 60, 70, 80, 90, 99]
    )
    return np.unique(guesses)
