"""Differentiable camera-pose parameterization and pose math.

Counterpart of nerf_from_image_tpu/pose/pose.py. The pose optimized during
hybrid inversion is (z0 = log(2f - 1), t2 = screen translation, s = scale,
q = quaternion (w, x, y, z)); `pose_to_matrix` / `matrix_to_pose` convert
to and from scaled cam2world matrices [B, 4, 4] whose [3, 3] entry holds
the inverse ortho scale. `matrix_to_conditioning_vector`,
`perturb_poses` and `rotation_matrix_distance` serve the discriminator,
the pose-robustness ablation and the inversion metrics.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    """The [B, 1, 4] row (0, 0, 0, 1) in `like`'s dtype and device."""
    row = torch.zeros(like.shape[0], 1, 4, dtype=like.dtype, device=like.device)
    row[:, 0, 3] = 1.0
    return row


def invert_space(mat: torch.Tensor) -> torch.Tensor:
    """Converts a scaled view matrix cam2world <-> world2cam ([B, 4, 4])."""
    rot = mat[:, :3, :3].transpose(-2, -1) / mat[:, 3:4, 3:4]
    t = -torch.sum(mat[:, :3, :3] / mat[:, 3:4, 3:4] * mat[:, :3, None, 3], dim=-2)
    top = torch.cat((rot, t[:, :, None]), dim=-1)
    return torch.cat((top, _bottom_row(mat)), dim=-2)


def quaternion_rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotates vectors v [B, N, 3] by unit quaternions q [B, 4] (w, x, y, z)."""
    qvec = q[:, None, 1:].expand(v.shape)
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[:, None, :1] * uv + uuv)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [B, 4] -> rotation matrix [B, 3, 3]."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    return quaternion_rotate_vector(q, eye)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Scaled 4x4 view matrices [B, 4, 4] (or one [4, 4]) -> quaternions
    [B, 4] (w, x, y, z): the branchless Shepperd selection of the JAX
    package, including its use of the scale entry M[3, 3]."""
    single = m.dim() == 2
    if single:
        m = m[None]
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    m33 = m[:, 3, 3]

    # Case w: trace4 > M33  <=>  trace3 > 0.
    t_w = m00 + m11 + m22 + m33
    q_w = torch.stack((t_w, m21 - m12, m02 - m20, m10 - m01), dim=-1)

    def diag_case(i, j, k, mii, mjj, mkk, mij, mji, mki, mik, mkj, mjk):
        t = mii - (mjj + mkk) + m33
        comp = [None, None, None, None]
        comp[i] = t
        comp[j] = mij + mji
        comp[k] = mki + mik
        comp[3] = mkj - mjk
        # (x, y, z, w) -> (w, x, y, z).
        return torch.stack((comp[3], comp[0], comp[1], comp[2]), dim=-1), t

    q_0, t_0 = diag_case(0, 1, 2, m00, m11, m22, m01, m10, m20, m02, m21, m12)
    q_1, t_1 = diag_case(1, 2, 0, m11, m22, m00, m12, m21, m01, m10, m02, m20)
    q_2, t_2 = diag_case(2, 0, 1, m22, m00, m11, m20, m02, m12, m21, m10, m01)

    i0_is_1 = m11 > m00
    mii0 = torch.where(i0_is_1, m11, m00)
    use_2 = m22 > mii0
    q_diag = torch.where(
        use_2[:, None], q_2, torch.where(i0_is_1[:, None], q_1, q_0)
    )
    t_diag = torch.where(use_2, t_2, torch.where(i0_is_1, t_1, t_0))

    use_w = (m00 + m11 + m22) > 0
    q = torch.where(use_w[:, None], q_w, q_diag)
    t = torch.where(use_w, t_w, t_diag)

    q = q * (0.5 / torch.sqrt(t * m33))[:, None]
    return q[0] if single else q


def pose_to_matrix(
    z0: Optional[torch.Tensor],
    t2: torch.Tensor,
    s: torch.Tensor,
    q: torch.Tensor,
    camera_flipped: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pose parameters -> (cam2world [B, 4, 4], focal [B] or None).

    Perspective (z0 given): f = 1 + exp(z0), the camera sits at distance
    f/s with screen translation t2/s, focal = f/2. Orthographic (z0 None):
    t3 = (t2, 1)/s. camera_flipped negates the y and z axes and the
    translation.
    """
    rot = quaternion_to_matrix(q)
    if z0 is not None:
        f = 1.0 + torch.exp(z0)
        t3 = torch.cat(((t2 / s[:, None]), (f / s)[:, None]), dim=-1)
        focal = f / 2.0
    else:
        t3 = torch.cat((t2, torch.ones_like(t2[:, :1])), dim=-1) / s[:, None]
        focal = None
    trans = torch.sum(t3[:, None, :] * rot, dim=-1)  # R @ t3

    if camera_flipped:
        flip = torch.tensor([1.0, -1.0, -1.0], dtype=rot.dtype, device=rot.device)
        rot = rot * flip[None, None, :]
        trans = -trans

    top = torch.cat((rot, trans[:, :, None]), dim=-1)  # [B, 3, 4]
    return torch.cat((top, _bottom_row(top)), dim=-2), focal


def matrix_to_pose(
    tform_cam2world: torch.Tensor,
    focal_length: Optional[torch.Tensor],
    camera_flipped: bool,
):
    """cam2world [B, 4, 4] -> (z0, t2, s, q), the inverse of pose_to_matrix."""
    m = tform_cam2world
    if camera_flipped:
        flip = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=m.dtype, device=m.device)
        m = torch.cat((m[:, :3, :] * flip[None, None, :], m[:, 3:, :]), dim=-2)
    m_inv = invert_space(m)
    t3 = -m_inv[:, :3, 3]

    if focal_length is not None:
        z0 = torch.log(2.0 * focal_length - 1.0)
        s = 2.0 * focal_length / t3[:, 2]
    else:
        z0 = None
        s = 1.0 / t3[:, 2]

    t2 = t3[:, :2] * s[:, None]
    q = matrix_to_quaternion(m_inv)
    return z0, t2, s, q


def matrix_to_conditioning_vector(
    tform_cam2world: torch.Tensor,
    focal_length: Optional[torch.Tensor],
    camera_flipped: bool,
) -> torch.Tensor:
    """View matrix [B, 4, 4] -> the 13-dim discriminator pose conditioning
    (z0, t2, s, R flattened); z0 = log(focal), unshifted."""
    m = tform_cam2world
    if camera_flipped:
        flip = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=m.dtype, device=m.device)
        m = torch.cat((m[:, :3, :] * flip[None, None, :], m[:, 3:, :]), dim=-2)
    m_inv = invert_space(m)
    rot_flat = m_inv[:, :3, :3].reshape(m.shape[0], 9)
    t3 = -m_inv[:, :3, 3]

    if focal_length is not None:
        z0 = torch.log(focal_length)
        s = 2.0 * focal_length / t3[:, 2]
    else:
        s = 1.0 / t3[:, 2]
        z0 = torch.zeros_like(s)

    t2 = t3[:, :2] * s[:, None]
    return torch.cat((z0[:, None], t2, s[:, None], rot_flat), dim=-1)


def rotation_matrix_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Geodesic distance in degrees between rotations [B, 3, 3], or scaled
    view matrices [B, 4, 4]; the cosine is clipped to [-1, 1] first."""
    if p.shape[-1] == 4:
        p = p[:, :3, :3] / p[:, 3:4, 3:4]
        q = q[:, :3, :3] / q[:, 3:4, 3:4]
    pqt = p @ q.transpose(-2, -1)
    trace = pqt[:, 0, 0] + pqt[:, 1, 1] + pqt[:, 2, 2]
    cos_d = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(cos_d) / math.pi * 180.0


def perturb_poses(tform_cam2world, avg_angle: float, *extra_args, seed=1234,
                  target_distances=None):
    """Pose-robustness ablation: swaps each pose for the dataset pose
    nearest a random target angular distance from it, drawn in [0,
    2 * avg_angle) by numpy's RandomState(seed). Host-side; poses [B, 4, 4]
    or [B, 3, 3] (numpy, compared in f32). Returns (poses, *extra) as numpy,
    each reordered by the same indices. `target_distances` [B] replaces the
    random targets."""
    poses = np.asarray(tform_cam2world)
    p = torch.as_tensor(poses, dtype=torch.float32)
    n, shape = len(poses), p.shape[1:]
    dists_all = rotation_matrix_distance(
        p[:, None].expand(n, n, *shape).reshape(n * n, *shape),
        p[None].expand(n, n, *shape).reshape(n * n, *shape),
    ).reshape(n, n).numpy()
    if target_distances is None:
        rng = np.random.RandomState(seed)
        target_distances = rng.rand(n) * avg_angle * 2
    indices = [int(np.abs(dists_all[i] - target_distances[i]).argmin())
               for i in range(n)]
    out_extra = [
        (np.asarray(a)[indices].copy() if a is not None else None)
        for a in extra_args
    ]
    return (poses[indices].copy(), *out_extra)
