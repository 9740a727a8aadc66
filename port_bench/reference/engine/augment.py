"""ADA-style differentiable augmentation, applied alike to images and to
camera poses/focals.

Counterpart of nerf_from_image_tpu/engine/augment.py: a random 2D
rotation/scale/translation is applied to the image through an affine
grid sample, and the same transform is pushed through the camera (pose
post-multiplication, focal rescale, screen-space shift of the camera
center), so that image and pose stay consistent.

Transforms are drawn from an explicit torch.Generator. They cannot match
the JAX package's draws from a key, so the tests feed one transform to
both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from port_bench.reference.ops.grid_sample import grid_sample_2d_zeros_packed
from port_bench.reference.parallel import mesh
from port_bench.reference.pose.pose import invert_space


class AugmentTransform(NamedTuple):
    rot: torch.Tensor  # [B]
    scale: torch.Tensor  # [B]
    translation: torch.Tensor  # [B, 2]


def sample_transform(
    generator: Optional[torch.Generator],
    batch_size: int,
    p: float,
    disable_scale: bool = False,
    device=None,
    dtype=torch.float32,
) -> AugmentTransform:
    """Draws the per-sample augmentation parameters: each of rotation,
    scale and translation is applied with probability p. The six draws are
    taken whether or not scale is disabled, so the others do not depend on
    it."""
    def uniform(*shape):
        return mesh.draw(torch.rand, shape, generator=generator, device=device, dtype=dtype)

    def normal(*shape):
        return mesh.draw(torch.randn, shape, generator=generator, device=device, dtype=dtype)

    rot = (uniform(batch_size) - 0.5) * 2.0 * math.pi
    rot = rot * (uniform(batch_size) < p).to(dtype)
    scale = torch.exp2(normal(batch_size) * 0.2)
    keep = (uniform(batch_size) < p).to(dtype)
    scale = torch.ones_like(scale) if disable_scale else 1.0 + (scale - 1.0) * keep
    translation = normal(batch_size, 2) * 0.1
    translation = translation * (uniform(batch_size, 1) < p).to(dtype)
    return AugmentTransform(rot, scale, translation)


def _affine_mat(tform: AugmentTransform) -> torch.Tensor:
    """[B, 2, 3] affine_grid matrix (rotation + translation, unscaled)."""
    c, s = torch.cos(tform.rot), torch.sin(tform.rot)
    tx, ty = tform.translation[:, 0], tform.translation[:, 1]
    row0 = torch.stack((c, -s, tx), dim=-1)
    row1 = torch.stack((s, c, -ty), dim=-1)
    return torch.stack((row0, row1), dim=-2)


def augment_image(img: torch.Tensor, tform: AugmentTransform,
                  white_background: bool) -> torch.Tensor:
    """Applies the affine transform to [B, H, W, C] images (zeros outside,
    or white with `white_background`)."""
    B, H, W, C = img.shape
    mat = _affine_mat(tform)
    mat_scaled = mat * tform.scale[:, None, None]
    # Rotate the scaled translation column by the unscaled rotation. The
    # 2- and 3-term products are written out: summed in this order they
    # give the JAX package's coordinates bit for bit (a batched matmul
    # does not), and a last-bit change of a sample coordinate can flip a
    # max-pool tie in LPIPS.
    t = mat_scaled[:, :, 2]
    t_rot = mat[:, :, 0] * t[:, :1] + mat[:, :, 1] * t[:, 1:]
    mat_scaled = torch.cat((mat_scaled[:, :, :2], t_rot[:, :, None]), dim=-1)

    # affine_grid with align_corners=False: output pixel centers in [-1, 1].
    xs = (2.0 * torch.arange(W, dtype=img.dtype, device=img.device) + 1.0) / W - 1.0
    ys = (2.0 * torch.arange(H, dtype=img.dtype, device=img.device) + 1.0) / H - 1.0
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    gx, gy = gx.reshape(1, -1, 1), gy.reshape(1, -1, 1)
    m = mat_scaled[:, None]  # [B, 1, 2, 3]
    coords = m[..., 0] * gx + m[..., 1] * gy + m[..., 2]  # [B, H*W, 2]

    if white_background:
        img = img - 1.0
    out = grid_sample_2d_zeros_packed(img, coords).reshape(B, H, W, C)
    if white_background:
        out = out + 1.0
    return out


def augment_pose(pose: torch.Tensor, focal: Optional[torch.Tensor],
                 tform: AugmentTransform) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Applies the same 2D transform to the camera: pose [B, 4, 4] and
    focal [B] (None for an orthographic camera, whose scale then goes into
    the pose)."""
    mat = _affine_mat(tform)
    B = pose.shape[0]
    M = torch.eye(4, dtype=pose.dtype, device=pose.device).repeat(B, 1, 1)
    M[:, :2, :2] = mat[:, :2, :2]
    pose_new = pose @ M.transpose(-2, -1)
    if focal is not None:
        focal_new = focal / tform.scale
    else:
        focal_new = None
        scale = tform.scale[:, None, None]
        pose_new = torch.cat((
            torch.cat((pose_new[:, :3, :3] * scale, pose_new[:, :3, 3:]), dim=-1),
            torch.cat((pose_new[:, 3:, :3], pose_new[:, 3:, 3:] * scale), dim=-1),
        ), dim=-2)

    pose_orig = pose_new
    cam_inv = invert_space(pose_new)
    if focal is not None:
        shift = tform.translation * (-cam_inv[:, 2:3, 3] / (2.0 * focal_new[:, None]))
    else:
        shift = tform.translation * pose_orig[:, 3:4, 3]
    cam_inv = cam_inv.clone()
    cam_inv[:, :2, 3] = cam_inv[:, :2, 3] - shift
    pose_new = invert_space(cam_inv)
    if focal is None:
        pose_new = pose_new.clone()
        pose_new[:, :3, :3] = pose_new[:, :3, :3] * pose_orig[:, 3:4, 3:4]
        pose_new[:, 3, 3] = pose_new[:, 3, 3] * pose_orig[:, 3, 3]
    return pose_new, focal_new


def augment(
    generator: Optional[torch.Generator],
    img: Optional[torch.Tensor],
    pose: Optional[torch.Tensor],
    focal: Optional[torch.Tensor],
    p: float,
    white_background: bool,
    disable_scale: bool = False,
    tform: Optional[AugmentTransform] = None,
):
    """Draws (or reuses) a transform and applies it to image and camera.
    Returns (img, pose, focal, tform)."""
    ref = img if img is not None else pose
    if tform is None:
        tform = sample_transform(generator, ref.shape[0], p, disable_scale,
                                 device=ref.device, dtype=ref.dtype)
    img_new = augment_image(img, tform, white_background) if img is not None else None
    if pose is not None:
        pose_new, focal_new = augment_pose(pose, focal, tform)
    else:
        pose_new, focal_new = None, focal
    return img_new, pose_new, focal_new, tform
