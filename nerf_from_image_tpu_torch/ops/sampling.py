"""Depth samples: stratified ray sampling and inverse-CDF importance sampling.

Counterpart of nerf_from_image_tpu/ops/sampling.py, with the stratified
volume samples of the SDF regularizers. Randomness comes from
an explicit torch.Generator on the tensors' device; `generator=None`
selects the deterministic variants (bin left edges, linspace quantiles).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def compute_query_points_from_rays(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified depth sampling in [near, far] along each ray.

    ray_origins/ray_directions: [B, H, W, 3]; near/far: origins.shape[:-1]
    or [B]. Returns (query_points [..., S, 3], depth_values [..., S]).
    """
    dtype = ray_origins.dtype
    near_plane = near[..., None]
    far_plane = far[..., None]
    frac = torch.arange(num_samples, dtype=dtype, device=ray_origins.device)
    frac = frac / num_samples
    depth_values = near_plane + (far_plane - near_plane) * frac

    if depth_values.ndim != ray_origins.ndim:
        # near/far given per batch element: broadcast across the pixel grid.
        expand = (slice(None),) + (None,) * (ray_origins.ndim - 2) + (slice(None),)
        depth_values = depth_values[expand]
        near_plane = near_plane[expand]
        far_plane = far_plane[expand]

    if generator is not None:
        delta = (far_plane - near_plane) / num_samples
        jitter = torch.rand(
            depth_values.shape, generator=generator, dtype=dtype,
            device=depth_values.device,
        )
        depth_values = depth_values + jitter * delta

    query_points = (
        ray_origins[..., None, :]
        + ray_directions[..., None, :] * depth_values[..., :, None]
    )
    return query_points, depth_values


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of new depths from per-bin weights.

    bins: [N, M], nondecreasing along M; weights: [N, M-1]. Returns
    [N, num_samples]. The searchsorted-and-gather of the reference is
    written, as in the JAX package, as masked prefix extrema: since cdf and
    bins are both nondecreasing, x[below] is the max of x over
    {m : cdf_m <= u} and x[above] the min over {m : cdf_m > u}.
    """
    dtype = weights.dtype
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat((torch.zeros_like(cdf[..., :1]), cdf), dim=-1)  # [N, M]

    shape = cdf.shape[:-1] + (num_samples,)
    if generator is None:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=dtype, device=cdf.device)
        u = u.expand(shape)
    else:
        u = torch.rand(shape, generator=generator, dtype=dtype, device=cdf.device)

    mask = cdf[..., None, :] <= u[..., :, None]

    def below_of(x):
        return torch.where(mask, x[..., None, :], -torch.inf).amax(dim=-1)

    def above_of(x):
        v = torch.where(mask, torch.inf, x[..., None, :]).amin(dim=-1)
        return torch.where(torch.isfinite(v), v, x[..., -1:])

    cdf_below = below_of(cdf)
    cdf_above = above_of(cdf)
    bins_below = below_of(bins)
    bins_above = above_of(bins)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_volume_stratified(
    generator: Optional[torch.Generator],
    batch_size: int,
    nstrata: int,
    scene_range: float,
    dtype=torch.float32,
    device=None,
    jitter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified 3D volume samples in [-scene_range, scene_range]^3: one
    jittered sample per cell of an (nstrata-1)^3 grid, the cells in the JAX
    package's meshgrid(indexing='xy') order. `jitter` [batch_size,
    (nstrata-1)^3, 3] in [0, 1) replaces the draw from `generator`.
    Returns [batch_size, (nstrata-1)^3, 3].
    """
    n = nstrata - 1
    grid = torch.arange(n, dtype=dtype, device=device)
    gx, gy, gz = torch.meshgrid(grid, grid, grid, indexing="xy")
    cells = torch.stack((gx, gy, gz), dim=-1).reshape(1, -1, 3)
    cells = cells.expand(batch_size, n * n * n, 3)
    if jitter is None:
        jitter = torch.rand(cells.shape, generator=generator, dtype=dtype,
                            device=device)
    return ((cells + jitter) / n * 2.0 - 1.0) * scene_range
