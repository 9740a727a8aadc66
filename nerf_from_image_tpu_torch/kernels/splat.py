"""The triplane-sampling op with the hand-written splat backward.

Counterpart of nerf_from_image_tpu/ops/pallas/splat.py::triplane_sample_mean
(the custom_vjp whose backward launches the Pallas kernel _splat3_kernel).

- Forward (tensor ops): cast the planes to the table dtype, corner-pack,
  one row gather per plane per point, bilinear FMA, mean of the planes.
  It saves the coordinates and, per plane, the pre-contracted corner
  differences (u_x, u_y) the coordinate gradient needs.
- Plane gradient: `splat3_backward`, the CUDA kernel in csrc/splat.cu on a
  CUDA tensor, its plain version `splat3_backward_reference` (index_add_
  of the four weighted corners per plane) on a CPU tensor. The caller may
  name the points' ray grid (img_shape, as the JAX op takes it); the kernel
  then accumulates ray-coherent blocks of `block_shape` on chip. Without a
  grid it blocks contiguous points. The function is the same either way.
- Coordinate gradient (tensor ops): from (u_x, u_y), with jnp.clip's
  convention of 0.5 at an exact clip boundary written out explicitly.

First-order only: the backward is not itself differentiable.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from nerf_from_image_tpu_torch.kernels import build
from nerf_from_image_tpu_torch.ops.triplane import (
    pack_corners,
    pixel_coords,
    plane_coords,
    sample_packed_with_rows,
)


# The JAX package's RenderConfig.splat_block: an image tile of 16 x 16 rays
# by a slab of 4 samples per block.
SPLAT_BLOCK = (16, 16, 4)
# Points per block that the kernel takes (a CTA of 512 threads, two points
# per thread).
MAX_BLOCK_POINTS = 1024

Shape3 = Tuple[int, int, int]


def _splat_lib() -> ctypes.CDLL:
    lib = build.load("splat")
    fn = lib.splat3_backward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check_splat_args(coords3: torch.Tensor, g: torch.Tensor, H: int, W: int):
    if coords3.dim() != 3 or coords3.shape[-1] != 3:
        raise ValueError(f"coords3 must be [B, N, 3], got {tuple(coords3.shape)}")
    if g.dim() != 3 or g.shape[:2] != coords3.shape[:2]:
        raise ValueError(
            f"g must be [B, N, C] matching coords3, got {tuple(g.shape)}"
        )
    if coords3.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(
            f"splat3_backward takes float32 coords and g, got "
            f"{coords3.dtype} and {g.dtype}"
        )
    if coords3.device != g.device:
        raise ValueError(f"coords3 on {coords3.device} but g on {g.device}")
    if not (coords3.is_contiguous() and g.is_contiguous()):
        raise ValueError("splat3_backward needs contiguous coords3 and g")
    if H < 2 or W < 2:
        raise ValueError(f"planes must be at least 2x2, got {H}x{W}")


def _is_shape3(x) -> bool:
    return (isinstance(x, (tuple, list)) and len(x) == 3
            and all(isinstance(v, int) and v > 0 for v in x))


def grid_and_block(n_points: int, img_shape: Optional[Shape3],
                   block_shape: Shape3) -> Tuple[Shape3, Shape3]:
    """(grid, block) the kernel walks: the ray grid (Hi, Wi, S) with
    Hi * Wi * S = n_points in blocks of (th, tw, ts), or without a grid the
    points in order, (1, 1, N) in blocks of (1, 1, th * tw * ts)."""
    if not _is_shape3(block_shape):
        raise ValueError(f"block_shape must be 3 positive ints, got {block_shape}")
    n_block = math.prod(block_shape)
    if n_block > MAX_BLOCK_POINTS:
        raise ValueError(
            f"block_shape {tuple(block_shape)} has {n_block} points; the kernel "
            f"takes at most {MAX_BLOCK_POINTS}")
    if img_shape is None:
        return (1, 1, n_points), (1, 1, n_block)
    if not _is_shape3(img_shape) or math.prod(img_shape) != n_points:
        raise ValueError(
            f"img_shape {img_shape} is not a ray grid of the {n_points} points")
    return tuple(img_shape), tuple(block_shape)


def _corner_updates(coords3: torch.Tensor, g: torch.Tensor, H: int, W: int):
    """Yields (flat row index [B*N], weighted rows [B*N, C]) for each of
    the 12 (plane, corner) updates, indexing the [B*3*H*W, C] gradient."""
    B, N, C = g.shape
    gf = g.reshape(B * N, C)
    b = torch.arange(B, device=g.device)[:, None]
    for p, c2 in enumerate(plane_coords(coords3)):
        ix, iy = pixel_coords(c2, H, W)
        x0f = torch.clamp_max(torch.floor(ix), W - 2)
        y0f = torch.clamp_max(torch.floor(iy), H - 2)
        wx1 = ix - x0f
        wy1 = iy - y0f
        wx0 = 1.0 - wx1
        wy0 = 1.0 - wy1
        base = ((b * 3 + p) * H + y0f.long()) * W + x0f.long()  # [B, N]
        corners = ((0, wy0 * wx0), (1, wy0 * wx1), (W, wy1 * wx0),
                   (W + 1, wy1 * wx1))
        for offset, w in corners:
            yield (base + offset).reshape(-1), gf * w.reshape(-1, 1)


def splat3_backward_reference(
    coords3: torch.Tensor, g: torch.Tensor, H: int, W: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: index_add_ of the four
    weighted corners of each point on each plane.

    coords3: [B, N, 3] in [-1, 1]; g: [B, N, C] (already divided by 3).
    Returns the plane gradients [B, 3, H, W, C] in f32.
    """
    B, N, C = g.shape
    out = torch.zeros(B * 3 * H * W, C, dtype=torch.float32, device=g.device)
    for idx, rows in _corner_updates(coords3, g, H, W):
        out.index_add_(0, idx, rows)
    return out.reshape(B, 3, H, W, C)


def splat_corners(coords3: torch.Tensor, g: torch.Tensor, H: int, W: int):
    """All 12 corner updates concatenated, (index [12*B*N], rows
    [12*B*N, C]): what one `index_put_(accumulate=True)` on the
    [B*3*H*W, C] gradient needs to compute the same function. A timing
    yardstick for the kernel; the port itself never calls it."""
    idx, rows = zip(*_corner_updates(coords3, g, H, W))
    return torch.cat(idx), torch.cat(rows)


def splat3_backward(
    coords3: torch.Tensor,
    g: torch.Tensor,
    H: int,
    W: int,
    img_shape: Optional[Shape3] = None,
    block_shape: Shape3 = SPLAT_BLOCK,
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plane gradients [B, 3, H, W, C] f32 of the 3-plane bilinear mean.

    img_shape: the points' ray grid (Hi, Wi, S), N = Hi * Wi * S, ray-major
    and sample-minor as the render makes them, or None for points in no
    known order; block_shape: the (th, tw, ts) blocks the kernel takes.
    On a CUDA tensor this launches the kernel of csrc/splat.cu on the
    current stream (and counts the launch in `splat3_backward.launches`);
    `stats`, an int64 CUDA tensor of 3, then receives the (block, plane)
    pairs whose footprint did not fit shared memory, all (block, plane)
    pairs, and the bytes reduced into device memory. On a CPU tensor
    it runs splat3_backward_reference. There is no other path: a CUDA
    launch that fails raises.
    """
    _check_splat_args(coords3, g, H, W)
    B, N, C = g.shape
    (Hi, Wi, S), (th, tw, ts) = grid_and_block(N, img_shape, block_shape)
    if coords3.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats are counted by the CUDA kernel only")
        return splat3_backward_reference(coords3, g, H, W)
    if coords3.device.type != "cuda":
        raise ValueError(f"splat3_backward runs on cuda or cpu, not {coords3.device}")
    if C % 4 or (C > 32 and C % 32) or g.data_ptr() % 16:
        raise ValueError(
            f"the kernel takes g rows of a multiple of 4 channels (of 32 above "
            f"32) on 16-byte boundaries, got C={C} at address {g.data_ptr():#x}")
    if stats is not None and not (stats.dtype == torch.int64 and stats.shape == (3,)
                                  and stats.device == g.device):
        raise ValueError("stats must be an int64 tensor of 3 on the device of g")
    out = torch.zeros((B, 3, H, W, C), dtype=torch.float32, device=g.device)
    lib = _splat_lib()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.splat3_backward(
        coords3.data_ptr(), g.data_ptr(), out.data_ptr(), B, N, H, W, C,
        Hi, Wi, S, th, tw, ts, None if stats is None else stats.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"splat3_backward launch failed with CUDA error {rc}")
    splat3_backward.launches += 1
    return out


splat3_backward.launches = 0


def _dcoord_residual(rows, coords2, H, W):
    """Pre-contracts gathered corner rows [B*N, 4C] into [B*N, 2C]:

        u_x = wy0*(r01-r00) + wy1*(r11-r10)   (d out / d ix)
        u_y = wx0*(r10-r00) + wx1*(r11-r01)   (d out / d iy)
    """
    C = rows.shape[-1] // 4
    ix, iy = pixel_coords(coords2, H, W)
    ix = ix.reshape(-1, 1)
    iy = iy.reshape(-1, 1)
    x0f = torch.clamp_max(torch.floor(ix), W - 2)
    y0f = torch.clamp_max(torch.floor(iy), H - 2)
    wx1 = (ix - x0f).to(rows.dtype)
    wy1 = (iy - y0f).to(rows.dtype)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    r00 = rows[:, :C]
    r01 = rows[:, C : 2 * C]
    r10 = rows[:, 2 * C : 3 * C]
    r11 = rows[:, 3 * C :]
    u_x = wy0 * (r01 - r00) + wy1 * (r11 - r10)
    u_y = wx0 * (r10 - r00) + wx1 * (r11 - r01)
    return torch.cat((u_x, u_y), dim=-1)


def _saturation_grad(raw: torch.Tensor, hi: float) -> torch.Tensor:
    """d clip(raw, 0, hi) / d raw with jnp.clip's convention: 1 inside,
    0 outside, 0.5 at an exact boundary hit."""
    inside = ((raw > 0.0) & (raw < hi)).float()
    edge = ((raw == 0.0) | (raw == hi)).float()
    return inside + 0.5 * edge


def _coord_grad_1plane(u, coords2, g, H, W):
    """d(sample)/d(coords2) [B, N, 2] from the residual u [B*N, 2C]."""
    B, N, C = g.shape
    uu = u.float()
    gf = g.reshape(-1, C)
    d_dix = torch.sum(gf * uu[:, :C], dim=-1).reshape(B, N)
    d_diy = torch.sum(gf * uu[:, C:], dim=-1).reshape(B, N)
    ix_raw = (coords2[..., 0] + 1.0) * 0.5 * (W - 1)
    iy_raw = (coords2[..., 1] + 1.0) * 0.5 * (H - 1)
    dx = d_dix * _saturation_grad(ix_raw, W - 1.0) * (0.5 * (W - 1))
    dy = d_diy * _saturation_grad(iy_raw, H - 1.0) * (0.5 * (H - 1))
    return torch.stack((dx, dy), dim=-1)


def table_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """'bfloat16' -> torch.bfloat16; None keeps the planes' dtype."""
    return None if name is None else getattr(torch, name)


class TriplaneSampleMean(torch.autograd.Function):
    """Mean of the three bilinearly sampled plane features, [B, N, C]."""

    @staticmethod
    def forward(ctx, planes, coords3, table_dtype, img_shape, block_shape):
        B, _, H, W, C = planes.shape
        grid_and_block(coords3.shape[1], img_shape, block_shape)  # fail here, not in backward
        dt = table_dtype_of(table_dtype)
        tp = planes.to(dt) if dt is not None else planes
        es, us = [], []
        for k, c2 in enumerate(plane_coords(coords3)):
            e, rows = sample_packed_with_rows(pack_corners(tp[:, k]), c2)
            es.append(e)
            us.append(_dcoord_residual(rows, c2, H, W))
            del rows
        ctx.save_for_backward(coords3, *us)
        ctx.plane_hw = (H, W)
        ctx.grid = (img_shape, block_shape)
        ctx.planes_dtype = planes.dtype
        return (es[0] + es[1] + es[2]) / 3.0

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mean):
        coords3, u1, u2, u3 = ctx.saved_tensors
        H, W = ctx.plane_hw
        g = (g_mean / 3.0).float().contiguous()
        dplanes = dcoords = None
        if ctx.needs_input_grad[0]:
            dplanes = splat3_backward(
                coords3.float().contiguous(), g, H, W, *ctx.grid
            ).to(ctx.planes_dtype)
        if ctx.needs_input_grad[1]:
            c_xy, c_xz, c_yz = plane_coords(coords3)
            g1 = _coord_grad_1plane(u1, c_xy, g, H, W)
            g2 = _coord_grad_1plane(u2, c_xz, g, H, W)
            g3 = _coord_grad_1plane(u3, c_yz, g, H, W)
            dx = g1[..., 0] + g2[..., 0]
            dy = g1[..., 1] + g3[..., 0]
            dz = g2[..., 1] + g3[..., 1]
            dcoords = torch.stack((dx, dy, dz), dim=-1).to(coords3.dtype)
        return dplanes, dcoords, None, None, None


def triplane_sample_mean(
    planes: torch.Tensor,
    coords3: torch.Tensor,
    table_dtype: Optional[str] = None,
    img_shape: Optional[Shape3] = None,
    block_shape: Shape3 = SPLAT_BLOCK,
) -> torch.Tensor:
    """Mean of the three bilinear plane samples.

    planes: [B, 3, H, W, C] raw triplanes; coords3: [B, N, 3] normalized
    points; table_dtype: 'bfloat16' for bf16 gather tables, None for
    strict f32; img_shape, block_shape: the points' ray grid and the splat
    blocks of the plane gradient (splat3_backward). Returns [B, N, C] in
    coords3's dtype.
    """
    return TriplaneSampleMean.apply(planes, coords3, table_dtype, img_shape, block_shape)
