"""Alpha compositing along the sample axis.

Counterpart of nerf_from_image_tpu/ops/compositing.py: the reference
compositor, its weights-only variant, EG3D weight smoothing, and the
sort-free dual-list compositor `composite_dual`.

`composite_dual` forms [..., S, S] all-pairs masks. In eager PyTorch each
one is materialized (1 GB in f32 at B=4, 128^2 rays, S=64); the masks and
`where`s whose inputs need no gradient are built without an autograd graph,
and the two cross-list sums keep only their boolean masks for the backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis."""
    cp = torch.cumprod(x[..., :-1], dim=-1)
    return torch.cat((torch.ones_like(cp[..., :1]), cp), dim=-1)


def _alpha_weights(sigma, ray_directions, depth_values):
    dists = torch.cat(
        (
            depth_values[..., 1:] - depth_values[..., :-1],
            torch.zeros_like(depth_values[..., :1]),
        ),
        dim=-1,
    )
    dists = dists * torch.linalg.vector_norm(ray_directions, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    return alpha * cumprod_exclusive(1.0 - alpha + 1e-10)


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor  # [..., C]
    depth: torch.Tensor  # [...]
    mask: torch.Tensor  # [...]
    normals: Optional[torch.Tensor]  # [..., 3] or None
    semantics: Optional[torch.Tensor]  # [..., K] or None


def render_volume_density(
    sigma: torch.Tensor,
    rgb: torch.Tensor,
    ray_directions: torch.Tensor,
    depth_values: torch.Tensor,
    normals: Optional[torch.Tensor] = None,
    semantics: Optional[torch.Tensor] = None,
    white_background: bool = True,
) -> CompositeOutput:
    """Composites per-sample sigma [..., S] and rgb [..., S, C] into maps.

    The depth map and the normal-map weights are computed from detached
    weights, as in the reference.
    """
    weights = _alpha_weights(sigma, ray_directions, depth_values)
    w_stop = weights.detach()

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(w_stop * depth_values.detach(), dim=-1)
    normal_map = None
    if normals is not None:
        normal_map = torch.sum(w_stop[..., None] * normals, dim=-2)
    semantic_map = None
    if semantics is not None:
        semantic_map = torch.sum(weights[..., None] * semantics, dim=-2)
    mask = torch.sum(weights, dim=-1)

    if white_background:
        rgb_map = rgb_map + (1.0 - mask[..., None])
        if normal_map is not None:
            normal_map = normal_map + (1.0 - mask[..., None])

    return CompositeOutput(rgb_map, depth_map, mask, normal_map, semantic_map)


def composite_dual(
    sigma_a: torch.Tensor,
    depth_a: torch.Tensor,
    channels_a: dict,
    sigma_b: torch.Tensor,
    depth_b: torch.Tensor,
    channels_b: dict,
    ray_directions: torch.Tensor,
    white_background: bool = True,
    stop_grad_channels: tuple = ("normals",),
) -> CompositeOutput:
    """Composites the merge of two individually sorted sample lists without
    sorting: equal to concatenating coarse (a) and fine (b), depth-sorting
    (ties a before b) and calling render_volume_density.

    sigma_a/b, depth_a/b: [..., S]; channels_a/b: {name: [..., S, C]};
    ray_directions: [..., 3]. Depths carry no gradient (they come from
    detached near/far planes and detached importance samples).
    """
    dn = torch.linalg.vector_norm(ray_directions, dim=-1)[..., None]
    depth_a = depth_a.detach()
    depth_b = depth_b.detach()
    inf = torch.inf

    def next_own(d):
        return torch.cat((d[..., 1:], torch.full_like(d[..., :1], inf)), dim=-1)

    # Boolean all-pairs masks: b_j >= a_i (rows a) and a_j > b_i (rows b).
    b_ge_a = depth_b[..., None, :] >= depth_a[..., :, None]
    a_gt_b = depth_a[..., None, :] > depth_b[..., :, None]
    first_b = torch.where(b_ge_a, depth_b[..., None, :], inf).amin(dim=-1)
    first_a = torch.where(a_gt_b, depth_a[..., None, :], inf).amin(dim=-1)

    next_a = torch.minimum(next_own(depth_a), first_b)
    next_b = torch.minimum(next_own(depth_b), first_a)
    delta_a = torch.where(torch.isfinite(next_a), next_a - depth_a, 0.0) * dn
    delta_b = torch.where(torch.isfinite(next_b), next_b - depth_b, 0.0) * dn

    alpha_a = 1.0 - torch.exp(-sigma_a * delta_a)
    alpha_b = 1.0 - torch.exp(-sigma_b * delta_b)
    log_ta = torch.log(1.0 - alpha_a + 1e-10)
    log_tb = torch.log(1.0 - alpha_b + 1e-10)

    def excl_cumsum(x):
        c = torch.cumsum(x[..., :-1], dim=-1)
        return torch.cat((torch.zeros_like(c[..., :1]), c), dim=-1)

    # Cross-list log-transmittance: the other list's log(1-alpha) summed
    # over samples strictly before (a) / at-or-before (b). b_j < a_i is
    # the complement of b_j >= a_i, and a_j <= b_i that of a_j > b_i.
    cross_a = torch.sum(torch.where(b_ge_a, 0.0, log_tb[..., None, :]), dim=-1)
    cross_b = torch.sum(torch.where(a_gt_b, 0.0, log_ta[..., None, :]), dim=-1)

    w_a = alpha_a * torch.exp(excl_cumsum(log_ta) + cross_a)
    w_b = alpha_b * torch.exp(excl_cumsum(log_tb) + cross_b)

    def weighted(name):
        wa, wb = w_a, w_b
        if name in stop_grad_channels:
            wa, wb = wa.detach(), wb.detach()
        return torch.sum(wa[..., None] * channels_a[name], dim=-2) + torch.sum(
            wb[..., None] * channels_b[name], dim=-2
        )

    rgb_map = weighted("rgb")
    mask = torch.sum(w_a, dim=-1) + torch.sum(w_b, dim=-1)
    depth_map = torch.sum(w_a.detach() * depth_a, dim=-1) + torch.sum(
        w_b.detach() * depth_b, dim=-1
    )
    normal_map = weighted("normals") if "normals" in channels_a else None
    semantic_map = weighted("semantics") if "semantics" in channels_a else None

    if white_background:
        rgb_map = rgb_map + (1.0 - mask[..., None])
        if normal_map is not None:
            normal_map = normal_map + (1.0 - mask[..., None])

    return CompositeOutput(rgb_map, depth_map, mask, normal_map, semantic_map)


def render_volume_density_weights_only(
    sigma: torch.Tensor,
    ray_directions: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """Compositing weights only (for importance sampling); no gradient."""
    with torch.no_grad():
        return _alpha_weights(sigma, ray_directions, depth_values)


def smooth_weights(weights: torch.Tensor, bias: float = 0.01) -> torch.Tensor:
    """EG3D weight smoothing: max-pool (k=2, s=1, pad=1) then avg-pool
    (k=2, s=1) over the sample axis, plus a uniform bias."""
    pad = torch.full_like(weights[..., :1], -torch.inf)
    padded = torch.cat((pad, weights, pad), dim=-1)  # [..., S+2]
    pooled = torch.maximum(padded[..., :-1], padded[..., 1:])  # [..., S+1]
    smoothed = 0.5 * (pooled[..., :-1] + pooled[..., 1:])  # [..., S]
    return smoothed + bias
