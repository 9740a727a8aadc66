"""Differentiable bilinear 2D grid sampling on NHWC tables.

Counterpart of nerf_from_image_tpu/ops/grid_sample.py. Tables are
[B, H, W, C] and samples [B, N, C]; coords [B, N, 2] are normalized to
[-1, 1] with coords[..., 0] indexing W. Built from row gathers and
elementwise math, so autograd differentiates it to any order.

Integer corner indices are clipped, which passes no gradient; the
coordinate gradient comes from the corner weights, which are computed
from the unclipped position (as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.ops.triplane import pack_corners


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows flat[idx] for idx [B, N] -> [B, N, row width]."""
    return flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[-1])


def _batch_offset(B: int, rows_per_batch: int, device) -> torch.Tensor:
    return (torch.arange(B, device=device) * rows_per_batch)[:, None]


def _cell(ix: torch.Tensor, iy: torch.Tensor):
    """Base cell (floor) and the four bilinear weights of a position."""
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    wx1 = ix - ix0
    wy1 = iy - iy0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    return ix0.long(), iy0.long(), (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)


def grid_sample_2d(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample(mode='bilinear', padding_mode='border',
    align_corners=True): -1 maps to pixel 0 and +1 to pixel W-1; corners
    outside clamp to the border."""
    B, H, W, C = table.shape
    ix = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    x0i, y0i, (w00, w01, w10, w11) = _cell(ix, iy)
    x0 = torch.clamp(x0i, 0, W - 1)
    x1 = torch.clamp(x0i + 1, 0, W - 1)
    y0 = torch.clamp(y0i, 0, H - 1)
    y1 = torch.clamp(y0i + 1, 0, H - 1)
    flat = table.reshape(B * H * W, C)
    offset = _batch_offset(B, H * W, table.device)

    def gather(yi, xi):
        return _gather(flat, yi * W + xi + offset)

    return (gather(y0, x0) * w00[..., None] + gather(y0, x1) * w01[..., None]
            + gather(y1, x0) * w10[..., None] + gather(y1, x1) * w11[..., None])


def _valid_weight(xi, yi, w, W, H, dtype):
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    return (w * valid.to(dtype))[..., None]


def grid_sample_2d_zeros(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False): pixel centers at (2i + 1) / W - 1; corners
    outside the table contribute zero."""
    B, H, W, C = table.shape
    ix = ((coords[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((coords[..., 1] + 1.0) * H - 1.0) * 0.5
    x0i, y0i, weights = _cell(ix, iy)
    flat = table.reshape(B * H * W, C)
    offset = _batch_offset(B, H * W, table.device)

    out = None
    for (dy, dx), w in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        yi, xi = y0i + dy, x0i + dx
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1) + offset
        term = _gather(flat, idx) * _valid_weight(xi, yi, w, W, H, table.dtype)
        out = term if out is None else out + term
    return out


def grid_sample_2d_zeros_packed(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample_2d_zeros through one corner-packed row gather per point:
    the same four corner values in the same FMA order. The table is
    zero-padded by one pixel, so the packed row at the clipped base cell
    holds the right 2x2 neighbourhood; corners outside the table are
    zeroed by the validity weights."""
    B, H, W, C = table.shape
    packed = pack_corners(F.pad(table, (0, 0, 1, 1, 1, 1)))  # [B, H+2, W+2, 4C]
    Hp, Wp = H + 2, W + 2
    ix = ((coords[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((coords[..., 1] + 1.0) * H - 1.0) * 0.5
    x0i, y0i, (w00, w01, w10, w11) = _cell(ix, iy)
    # The clip engages only when the whole 2x2 neighbourhood is outside,
    # where the validity weights zero every corner.
    xb = torch.clamp(x0i + 1, 0, Wp - 2)
    yb = torch.clamp(y0i + 1, 0, Hp - 2)
    rows = _gather(packed.reshape(B * Hp * Wp, 4 * C),
                   yb * Wp + xb + _batch_offset(B, Hp * Wp, table.device))
    dt = table.dtype
    return (rows[..., :C] * _valid_weight(x0i, y0i, w00, W, H, dt)
            + rows[..., C:2 * C] * _valid_weight(x0i + 1, y0i, w01, W, H, dt)
            + rows[..., 2 * C:3 * C] * _valid_weight(x0i, y0i + 1, w10, W, H, dt)
            + rows[..., 3 * C:] * _valid_weight(x0i + 1, y0i + 1, w11, W, H, dt))
