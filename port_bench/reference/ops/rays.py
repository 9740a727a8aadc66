"""Ray generation for perspective and orthographic cameras.

Counterpart of nerf_from_image_tpu/ops/rays.py. `focal_length=None`
selects the orthographic model; optional per-image principal point
`center` [B, 2] and normalized crop `bbox` [B, 2, 2].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def get_ray_bundle(
    height: int,
    width: int,
    focal_length: Optional[torch.Tensor],
    tform_cam2world: torch.Tensor,
    bbox: Optional[torch.Tensor] = None,
    center: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space ray origins and (unnormalized) directions, each
    [B, H, W, 3], for cam2world matrices [B, 4, 4]."""
    dtype, device = tform_cam2world.dtype, tform_cam2world.device
    ii = torch.arange(width, dtype=dtype, device=device)[None, :] / width
    jj = torch.arange(height, dtype=dtype, device=device)[:, None] / height
    ii = ii.expand(height, width)
    jj = jj.expand(height, width)

    rot = tform_cam2world[:, None, None, :3, :3]  # [B,1,1,3,3]
    t = tform_cam2world[:, None, None, :3, -1]  # [B,1,1,3]

    if focal_length is not None:
        if center is not None:
            ii = ii[None] - 0.5 * (2.0 * center[:, 0, None, None] - 1.0) - 0.5
            jj = jj[None] - 0.5 * (2.0 * center[:, 1, None, None] - 1.0) - 0.5
        else:
            ii = ii[None] - 0.5
            jj = jj[None] - 0.5

        if bbox is not None:
            ii = (bbox[:, 1:2, 0, None] * (ii + 0.5) + bbox[:, 0:1, 0, None]) * 0.5
            jj = -(bbox[:, 1:2, 1, None] * (-jj + 0.5) + bbox[:, 0:1, 1, None]) * 0.5

        inv_f = 1.0 / focal_length[:, None, None]
        ii = ii * inv_f
        jj = jj * inv_f

        # Flipped camera convention: look down -z, y up in image is -jj.
        directions = torch.stack((ii, -jj, -torch.ones_like(ii)), dim=-1)
        ray_directions = torch.sum(directions[..., None, :] * rot, dim=-1)
        ray_origins = t.expand(ray_directions.shape)
    else:
        ii = (ii[None] - 0.5) * 2.0
        jj = (jj[None] - 0.5) * 2.0

        if bbox is not None:
            ii = bbox[:, 1:2, 0, None] * (ii / 2.0 + 0.5) + bbox[:, 0:1, 0, None]
            jj = -(bbox[:, 1:2, 1, None] * (-jj / 2.0 + 0.5) + bbox[:, 0:1, 1, None])

        ii, jj = torch.broadcast_tensors(ii, jj)
        origins = torch.stack((ii, -jj, torch.zeros_like(ii)), dim=-1)
        directions = torch.cat(
            (torch.zeros_like(origins[..., :2]), -torch.ones_like(origins[..., :1])),
            dim=-1,
        )
        ray_origins = torch.sum(origins[..., None, :] * rot, dim=-1) + t
        inv_scale = tform_cam2world[:, None, None, 3, 3, None]
        ray_directions = torch.sum(directions[..., None, :] * rot, dim=-1) / inv_scale

    return ray_origins, ray_directions


def normalize_directions(ray_directions: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalizes ray directions along the last axis."""
    norm = torch.linalg.vector_norm(ray_directions, dim=-1, keepdim=True)
    return ray_directions / torch.clamp_min(norm, eps)
