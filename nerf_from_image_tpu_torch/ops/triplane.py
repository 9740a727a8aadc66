"""Triplane bilinear sampling via corner-packed gather rows.

Counterpart of nerf_from_image_tpu/ops/triplane.py. Each plane is packed
into a [H, W, 4C] table whose row (y, x) holds the 2x2 neighbourhood
[(y,x), (y,x+1), (y+1,x), (y+1,x+1)], so a bilinear sample is one row
gather per plane per point plus a 4-corner FMA.

Border semantics are grid_sample(padding_mode='border', align_corners=True):
pixel coordinates are clipped to [0, W-1] and the base cell to W-2. The
clip is written as minimum(maximum(.)) rather than torch.clamp: at an
exact boundary hit clamp's backward passes 1.0, while jnp.clip (and
torch.maximum/minimum) split the tie and pass 0.5. The near plane puts
every ray's first sample exactly on the box face, so such ties are common.
The bounds are 0-dim tensors made once per (device, dtype, value): one
made from a Python number on each call would wait for the device.
"""

from __future__ import annotations

import torch

from nerf_from_image_tpu_torch.utils.device import constant


def bound(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a shared 0-dim tensor of like's device and dtype."""
    value = float(value)
    # By the value's bits: 0.0 and -0.0 are equal as dict keys.
    return constant(("clip", like.device, like.dtype, value.hex()),
                    lambda: torch.full((), value, dtype=like.dtype, device=like.device))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with its gradient convention (0.5 at an exact tie)."""
    return torch.minimum(torch.maximum(x, bound(lo, x)), bound(hi, x))


def pixel_coords(coords2: torch.Tensor, H: int, W: int):
    """[-1, 1] plane coords [..., 2] -> clipped pixel coords (ix, iy)."""
    ix = clip((coords2[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1.0)
    iy = clip((coords2[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1.0)
    return ix, iy


def pack_corners(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H, W, 4C] corner-packed table (edge-clamped)."""
    right = torch.cat((plane[..., :, 1:, :], plane[..., :, -1:, :]), dim=-2)
    down = torch.cat((plane[..., 1:, :, :], plane[..., -1:, :, :]), dim=-3)
    down_right = torch.cat((down[..., :, 1:, :], down[..., :, -1:, :]), dim=-2)
    return torch.cat((plane, right, down, down_right), dim=-1)


def sample_packed_with_rows(packed: torch.Tensor, coords: torch.Tensor):
    """sample_packed, also returning the gathered corner rows [B*N, 4C]
    (in the table dtype) that the splat op's coordinate gradient needs."""
    B, H, W, C4 = packed.shape
    C = C4 // 4
    ix, iy = pixel_coords(coords, H, W)
    x0f = torch.clamp_max(torch.floor(ix), W - 2)
    y0f = torch.clamp_max(torch.floor(iy), H - 2)
    wx1 = ix - x0f
    wy1 = iy - y0f
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    offset = torch.arange(B, device=packed.device)[:, None] * (H * W)
    idx = (y0f.long() * W + x0f.long() + offset).reshape(-1)
    rows = packed.reshape(B * H * W, C4)[idx]
    # bf16 tables run the corner FMA in bf16 (as the JAX package does);
    # f32 tables are exact f32 throughout.
    fma_dtype = rows.dtype if rows.dtype == torch.bfloat16 else coords.dtype
    rows_f = rows.to(fma_dtype)

    w00 = (wy0 * wx0).reshape(-1, 1).to(fma_dtype)
    w01 = (wy0 * wx1).reshape(-1, 1).to(fma_dtype)
    w10 = (wy1 * wx0).reshape(-1, 1).to(fma_dtype)
    w11 = (wy1 * wx1).reshape(-1, 1).to(fma_dtype)
    out = (
        rows_f[:, :C] * w00
        + rows_f[:, C : 2 * C] * w01
        + rows_f[:, 2 * C : 3 * C] * w10
        + rows_f[:, 3 * C :] * w11
    )
    return out.to(coords.dtype).reshape(B, -1, C), rows


def sample_packed(packed: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinearly samples a corner-packed table.

    packed: [B, H, W, 4C] (f32 or bf16); coords: [B, N, 2] in [-1, 1],
    coords[..., 0] indexes W. Returns [B, N, C] in coords' dtype.
    """
    return sample_packed_with_rows(packed, coords)[0]


def plane_coords(coords3: torch.Tensor):
    """[..., 3] normalized points -> the (xy, xz, yz) plane coordinates."""
    x, y, z = coords3[..., 0], coords3[..., 1], coords3[..., 2]
    return (
        torch.stack((x, y), dim=-1),
        torch.stack((x, z), dim=-1),
        torch.stack((y, z), dim=-1),
    )
