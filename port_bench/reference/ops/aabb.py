"""Ray/axis-aligned-box intersection for near/far planes.

Counterpart of nerf_from_image_tpu/ops/aabb.py: a vectorized slab test with
no boolean indexing; rays that miss take the min near / max far over the
rays that hit. Gradients are stopped (the inputs are detached).
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_near_far_planes(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    scene_range: float,
    min_plane: float = 0.1,
    eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersects rays [..., 3] with the cube [-scene_range, scene_range]^3.

    Returns (near, far) of shape [...].
    """
    o = ray_origins.detach()
    d = ray_directions.detach()

    invdir = 1.0 / d
    neg = invdir < 0
    lo = torch.where(neg, scene_range, -scene_range).to(d.dtype)
    hi = torch.where(neg, -scene_range, scene_range).to(d.dtype)
    tmin = (lo - o) * invdir
    tmax = (hi - o) * invdir
    # An origin exactly on a face with a perpendicular direction gives
    # 0 * inf = NaN; treat that grazing ray as inside the slab.
    tmin = torch.where(torch.isnan(tmin), -torch.inf, tmin)
    tmax = torch.where(torch.isnan(tmax), torch.inf, tmax)

    xmin, ymin, zmin = tmin[..., 0], tmin[..., 1], tmin[..., 2]
    xmax, ymax, zmax = tmax[..., 0], tmax[..., 1], tmax[..., 2]

    hit = ~((xmin > ymax) | (ymin > xmax))
    near = torch.maximum(xmin, ymin)
    far = torch.minimum(xmax, ymax)
    hit = hit & ~((near > zmax) | (zmin > far))
    near = torch.maximum(near, zmin)
    far = torch.minimum(far, zmax)

    # Miss rays take the min/max over hit rays; if no ray hits at all, a
    # finite default range keeps the render finite.
    big = torch.finfo(near.dtype).max
    any_hit = hit.any()
    diag = 2.0 * 1.7320508 * scene_range
    near_hit_min = torch.where(
        any_hit, torch.where(hit, near, big).amin(), min_plane
    )
    far_hit_max = torch.where(
        any_hit, torch.where(hit, far, -big).amax(), min_plane + diag
    )
    near = torch.where(hit, near, near_hit_min)
    far = torch.where(hit, far, far_hit_max)

    near = torch.clamp_min(near, min_plane)
    far = torch.clamp_min(far, min_plane)
    far = torch.where(far - near < eps, near + eps, far)
    return near, far
