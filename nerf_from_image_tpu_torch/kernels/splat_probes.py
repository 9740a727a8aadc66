"""The splat probes P1 and P2 with their hand-written kernels.

Counterparts of the TPU probe kernels in scripts/profile_splat.py (P1: the
windowed tent-matrix splat, seven ablation stages) and
scripts/profile_splat_io.py (P2: launch overhead, g streaming and
coordinate streaming). Each wrapper launches its CUDA kernel
(csrc/splat_probes.cu) on a CUDA tensor and counts the launch in
`.launches`; on a CPU tensor it runs the plain PyTorch version beside it
(`*_reference`). A CUDA launch that fails raises.

Point blocks are laid out [B, nblocks, P, ...]: block (b, k) is the TPU
grid step (b, k), and its points' outputs land in out[b] of the
[B, H, W * C] f32 output. C is the model's 32 plane channels.

One difference from the TPU scripts, on purpose: where a script sums a
bf16 array (`jnp.sum` of Z in P1's z_only stage, of g in P2's read_g) it
gets a bf16 result, the f32 sum rounded once. Here the sums stay f32: a
bf16 rounding of sums taken in two orders (card and plain version) flips
by one bf16 ulp and would hide the kernel's own error.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nerf_from_image_tpu_torch.kernels import build

C = 32
STAGES = ("full", "static_store", "no_tile", "z_only", "oy_only", "bf16build",
          "dottile")
IO_VARIANTS = ("empty", "read_g", "read_ixy_P1", "read_ixy_2P", "transpose_2P")
# `empty` fills this corner of each batch element's output.
EMPTY_ROWS, EMPTY_COLS = 64, 2048
# P2's kernel: threads per CTA, CTAs per SM, and the corner quads (16
# bytes) a CTA of `empty` holds in registers, two a thread.
IO_THREADS = 256
IO_CTAS_PER_SM = 2
EMPTY_TILE_QUADS = 2 * IO_THREADS
_P_MULTIPLE = 64  # the kernel's k-steps and ring stages take whole 64s
# P1's kernel: at most this many f32 accumulators per thread (a warp holds
# WY rows x its columns), warps per CTA, points per ring stage, ring
# stages, and the shared memory a CTA may use on Hopper.
ACC_BUDGET = 128
MAX_WARPS = 8
RING_CHUNK = 128
RING_STAGES = 4
RING_HEADER = 128  # bytes: the ring's mbarriers
MAX_SMEM = 232448


def _lib() -> ctypes.CDLL:
    lib = build.load("splat_probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.splat_window_probe.argtypes = [p, p, p, p, p, p] + [i] * 14 + [p]
    lib.splat_window_probe.restype = i
    q = ctypes.c_longlong
    lib.splat_io_probe.argtypes = ([i] + [p] * 7 + [i] * 7 + [q] + [i] * 5 + [q, p])
    lib.splat_io_probe.restype = i
    return lib


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_points(iy, ix, g):
    if iy.dim() != 3:
        raise ValueError(f"iy must be [B, nblocks, P], got {tuple(iy.shape)}")
    B, nb, P = iy.shape
    _check("iy", iy, (B, nb, P), torch.float32, iy.device)
    _check("ix", ix, (B, nb, P), torch.float32, iy.device)
    _check("g", g, (B, nb, P, C), torch.bfloat16, iy.device)
    if iy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on cuda or cpu, not {iy.device}")
    return B, nb, P


def _check_window_args(oy0, ox0, iy, ix, g, H, W, WY, WX, stage):
    B, nb, P = _check_points(iy, ix, g)
    _check("oy0", oy0, (B, nb), torch.int32, iy.device)
    _check("ox0", ox0, (B, nb), torch.int32, iy.device)
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if P % _P_MULTIPLE or WY % 16 or not 16 <= WY <= min(128, H) \
            or (WX * C) % 128 or not 0 < WX <= W:
        raise ValueError(
            f"the window probe takes P % {_P_MULTIPLE} == 0, WY in 16..128 "
            f"(a multiple of 16, <= H) and WX % 4 == 0 (<= W); got P={P}, "
            f"WY={WY}, WX={WX}, H={H}, W={W}")
    return B, nb, P


class WindowPlan(NamedTuple):
    """How P1's kernel covers the windows: one CTA per (point block, slab)."""

    mt: int           # row fragments of 16 a warp holds: WY / 16 (z_only: 1)
    warp_cols: int    # window columns per warp
    warps: int        # warps per CTA
    slab_cols: int    # window columns per CTA: warps * warp_cols
    slabs: int        # CTAs per point block
    chunk: int        # points per ring stage
    ring: int         # ring stages
    smem_bytes: int   # dynamic shared memory per CTA
    accumulators: int  # f32 accumulators per thread


def window_launch_plan(stage, P, WY, WX) -> WindowPlan:
    """P1's launch plan for a window of WY rows and WX x-positions. A warp
    holds all WY rows of its columns (z_only: one row fragment, its column
    sums): 64 columns up to WY = 64, 32 above, so that no thread holds more
    than ACC_BUDGET accumulators; the CTA takes up to MAX_WARPS warps side
    by side. The block's points stream through RING_STAGES stages of up to
    RING_CHUNK points (iy, ix f32 and g bf16 each), and each warp keeps its
    own copy of a stage's points as 4 floats each."""
    ncols = WY if stage == "oy_only" else WX * C
    mt = 1 if stage == "z_only" else WY // 16
    warp_cols = (8 if mt <= 4 else 4) * 8
    warps = min(MAX_WARPS, -(-ncols // warp_cols))
    slab_cols = warps * warp_cols
    chunk = min(RING_CHUNK, P)
    smem = RING_HEADER + RING_STAGES * chunk * (2 * 4 + C * 2) + warps * chunk * 16
    return WindowPlan(mt, warp_cols, warps, slab_cols, -(-ncols // slab_cols),
                      chunk, RING_STAGES, smem, mt * (warp_cols // 8) * 4)


def _tents(oy0, ox0, iy, ix, H, W, WY, WX, stage):
    """(oy [n, P, WY], zx [n, P, WX]) bf16 for n flattened blocks, with the
    TPU kernel's op order and roundings."""
    x0f = torch.clamp_max(torch.floor(ix), W - 2.0)
    y0f = torch.clamp_max(torch.floor(iy), H - 2.0)
    wy1 = (iy - y0f)[..., None]
    wx1 = (ix - x0f)[..., None]
    yl0 = (y0f - oy0.float()[:, None])[..., None]
    xl0 = (x0f - ox0.float()[:, None])[..., None]
    ylanes = torch.arange(WY, dtype=torch.float32, device=iy.device)
    xlanes = torch.arange(WX, dtype=torch.float32, device=iy.device)
    oy = torch.clamp_min(1.0 - torch.abs(ylanes - yl0 - wy1), 0.0).to(torch.bfloat16)
    if stage == "bf16build":
        xc = (xl0 + wx1).to(torch.bfloat16)
        zx = torch.clamp_min(1.0 - torch.abs(xlanes.to(torch.bfloat16) - xc), 0.0)
    else:
        zx = torch.clamp_min(1.0 - torch.abs(xlanes - xl0 - wx1), 0.0).to(torch.bfloat16)
    return oy, zx


def _window_operand(zx, g, stage):
    """Z [n, P, WX*C] bf16: zx * tile(g), or zx alone (no_tile)."""
    n, P, WX = zx.shape
    if stage == "no_tile":
        return zx[..., None].expand(n, P, WX, C).reshape(n, P, WX * C)
    if stage == "dottile":
        cols = torch.arange(WX * C, device=g.device)
        tilemat = (cols[None] % C == torch.arange(C, device=g.device)[:, None]).float()
        gt = torch.matmul(g.float(), tilemat).to(torch.bfloat16)
    else:
        gt = g.repeat(1, 1, WX)
    return zx.repeat_interleave(C, dim=-1) * gt


def _chunk_blocks(P, WX, WY):
    """Blocks per chunk of the plain version: ~256 MB of f32 operand."""
    return max(1, (64 << 20) // (P * max(WX * C, WY)))


def splat_window_probe_reference(oy0, ox0, iy, ix, g, H, W, WY, WX, stage):
    """Plain PyTorch version of P1 (the TPU kernel's arithmetic in tensor
    ops: bf16 tents and operands, products and sums in f32), chunked over
    point blocks. Returns out [B, H, W * C] f32."""
    B, nb, P = _check_window_args(oy0, ox0, iy, ix, g, H, W, WY, WX, stage)
    dev = iy.device
    WC = W * C
    out = torch.zeros(B * H * WC, dtype=torch.float32, device=dev)
    flat = [t.reshape(B * nb, *t.shape[2:]) for t in (oy0, ox0, iy, ix, g)]
    step = _chunk_blocks(P, WX, WY)
    for s in range(0, B * nb, step):
        o0, x0, py, px, pg = (t[s:s + step] for t in flat)
        b = torch.arange(s, s + o0.shape[0], device=dev) // nb
        oy, zx = _tents(o0, x0, py, px, H, W, WY, WX, stage)
        if stage == "z_only":
            colsum = _window_operand(zx, pg, stage).float().sum(dim=1)
            out.view(B, H * WC)[:, : WX * C].index_add_(0, b, colsum)
            continue
        rhs = oy if stage == "oy_only" else _window_operand(zx, pg, stage)
        T = torch.bmm(oy.transpose(1, 2).float(), rhs.float())  # [n, WY, cols]
        rows = torch.arange(WY, device=dev)
        cols = torch.arange(T.shape[-1], device=dev)
        if stage in ("static_store", "oy_only"):
            r0 = torch.zeros_like(o0)
            c0 = torch.zeros_like(x0)
        else:
            r0, c0 = o0, x0 * C
        idx = ((b[:, None] * H + r0[:, None] + rows) * WC)[..., None] \
            + (c0[:, None] + cols)[:, None, :]
        out.index_add_(0, idx.reshape(-1), T.reshape(-1))
    return out.reshape(B, H, WC)


def splat_window_probe(oy0, ox0, iy, ix, g, H, W, WY, WX, stage):
    """P1: the windowed tent-matrix splat of one plane, stage `stage`.

    oy0, ox0: [B, nblocks] i32 window origins (oy0 a multiple of 8, ox0 of
    4; the window must lie inside the plane). iy, ix: [B, nblocks, P] f32
    pixel coordinates in [0, H-1] x [0, W-1]. g: [B, nblocks, P, 32] bf16.
    Returns out [B, H, W * 32] f32:

        full, dottile, no_tile, bf16build:
            out[b, oy0:oy0+WY, ox0*C:(ox0+WX)*C] += oy^T @ Z per block
        static_store:  the same window product added at the origin
        oy_only:       out[b, :WY, :WY] += oy^T @ oy
        z_only:        out[b, 0, :WX*C] += sum over the points of Z

    with oy[p, y] = max(0, 1 - |y - (y0f - oy0) - (iy - y0f)|) in bf16,
    zx likewise in x (every op rounded to bf16 for bf16build), y0f =
    min(floor(iy), H-2), and Z = zx * tile(g) (zx alone for no_tile; the
    tile as a product with a 0/1 matrix for dottile).

    On a CUDA tensor this launches the kernel of csrc/splat_probes.cu on the
    current stream with window_launch_plan's plan and counts it in
    `splat_window_probe.launches`; on a CPU tensor it runs
    splat_window_probe_reference.
    """
    B, nb, P = _check_window_args(oy0, ox0, iy, ix, g, H, W, WY, WX, stage)
    if iy.device.type == "cpu":
        return splat_window_probe_reference(oy0, ox0, iy, ix, g, H, W, WY, WX, stage)
    for name, t in (("iy", iy), ("ix", ix), ("g", g)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the bulk copies")
    plan = window_launch_plan(stage, P, WY, WX)
    out = torch.zeros((B, H, W * C), dtype=torch.float32, device=iy.device)
    rc = _lib().splat_window_probe(
        oy0.data_ptr(), ox0.data_ptr(), iy.data_ptr(), ix.data_ptr(), g.data_ptr(),
        out.data_ptr(), B, nb, P, H, W, WY, WX, STAGES.index(stage), plan.mt,
        plan.warps, plan.slab_cols, plan.chunk, plan.ring, plan.smem_bytes,
        torch.cuda.current_stream(iy.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"splat_window_probe ({stage}) launch failed with CUDA error {rc}")
    splat_window_probe.launches += 1
    return out


splat_window_probe.launches = 0


def _check_io_args(variant, iy, ix, ixy, g, H, W):
    B, nb, P = _check_points(iy, ix, g)
    _check("ixy", ixy, (B, nb, 2, P), torch.float32, iy.device)
    if variant not in IO_VARIANTS:
        raise ValueError(f"variant must be one of {IO_VARIANTS}, got {variant!r}")
    if P % 4 or H < 1 or W < 1:
        raise ValueError(f"the io probe takes P % 4 == 0, got P={P}")
    return B, nb, P


class IoPlan(NamedTuple):
    """How P2's persistent kernel covers the work: `ctas` CTAs, each
    zeroing a contiguous range of `zero_quads` 16-byte output quads (but
    for the quads that the corner's owners or the last CTA write), and
    either (empty) owning `corner_quads` quads of the corner [B, rows,
    cols], flattened batch, row, then quad, or (readers) walking
    `blocks_per_cta` consecutive point blocks of the B * nblocks, with the
    partial of `width` floats for each (CTA, batch element b) it touches
    at scratch[(CTA + b) * width]: the ranges are consecutive, so these
    slots are distinct and, in order, the pairs in (b, CTA) order."""

    ctas: int
    blocks_per_cta: int   # readers; 0 for empty
    zero_quads: int
    corner_rows: int      # empty: min(H, EMPTY_ROWS); else 0
    corner_cols: int      # empty: min(W * C, EMPTY_COLS); else 0
    corner_quads: int     # empty; else 0
    width: int            # readers: 32 (read_g) or 1; empty 0
    epilogue_quads: int   # readers: quads of out[b, 0] the last CTA writes
    scratch_floats: int   # readers: (ctas + B - 1) * width, rounded up to 4


def io_launch_plan(variant, B, nblocks, P, H, W, sms) -> IoPlan:
    """P2's launch plan on a card with `sms` SMs: about IO_CTAS_PER_SM CTAs
    an SM (empty: at least enough that each CTA's corner tile fits its
    registers), the work split evenly and in order."""
    total_quads = B * H * W * C // 4
    target = IO_CTAS_PER_SM * sms
    if variant == "empty":
        rows, cols = min(H, EMPTY_ROWS), min(W * C, EMPTY_COLS)
        corner = B * rows * cols // 4
        ctas = max(target, -(-corner // EMPTY_TILE_QUADS))
        return IoPlan(ctas, 0, -(-total_quads // ctas), rows, cols,
                      -(-corner // ctas), 0, 0, 0)
    blocks = B * nblocks
    per_cta = -(-blocks // min(target, blocks))
    ctas = -(-blocks // per_cta)
    width = C if variant == "read_g" else 1
    return IoPlan(ctas, per_cta, -(-total_quads // ctas), 0, 0, 0, width,
                  -(-width // 4), -(-(ctas + B - 1) * width // 4) * 4)


def splat_io_probe_reference(variant, iy, ix, ixy, g, H, W):
    """Plain PyTorch version of P2. Returns out [B, H, W * C] f32."""
    B, nb, P = _check_io_args(variant, iy, ix, ixy, g, H, W)
    out = torch.zeros((B, H, W * C), dtype=torch.float32, device=iy.device)
    if variant == "empty":
        out[:, :EMPTY_ROWS, :EMPTY_COLS] = float(nb)
    elif variant == "read_g":
        out[:, 0, :C] = g.float().sum(dim=(1, 2))
    elif variant == "read_ixy_P1":
        out[:, 0, 0] = (iy + ix).sum(dim=(1, 2))
    elif variant == "read_ixy_2P":
        out[:, 0, 0] = ixy.sum(dim=(1, 2, 3))
    else:  # transpose_2P
        ylanes = torch.arange(64, dtype=torch.float32, device=iy.device)
        oy = torch.clamp_min(1.0 - torch.abs(ylanes - ixy[:, :, 0, :, None]), 0.0)
        out[:, 0, 0] = (oy + 0.0 * ixy[:, :, 1, :, None]).sum(dim=(1, 2, 3))
    return out


# The kernel's ticket counter: one u32 per device, zeroed once; each call
# leaves it zero. Calls on one device must not overlap (one stream).
_tickets = {}


def _ticket(device) -> torch.Tensor:
    t = _tickets.get(device)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def splat_io_probe(variant, iy, ix, ixy, g, H, W):
    """P2: one streaming floor of the splat. iy, ix: [B, nblocks, P] f32;
    ixy: [B, nblocks, 2, P] f32 (iy and ix stacked per block); g:
    [B, nblocks, P, 32] bf16. Each variant reads only its inputs and
    returns out [B, H, W * 32] f32, zero but for:

        empty:         out[b, :64, :2048] = nblocks (each block adds 1.0)
        read_g:        out[b, 0, :32] = sum of g over the points
        read_ixy_P1:   out[b, 0, 0] = sum(iy + ix), from iy and ix
        read_ixy_2P:   out[b, 0, 0] = the same sum, from ixy
        transpose_2P:  out[b, 0, 0] = sum_p sum_{y<64} max(0, 1 - |y - iy|)

    On a CUDA tensor this launches the persistent kernel of
    csrc/splat_probes.cu once on the current stream, with io_launch_plan's
    plan; it writes the whole output (allocated with torch.empty, so a
    call is one launch and no memset) and sums in a fixed order, so that
    every call gives the same bits. The launch is counted in
    `splat_io_probe.launches`. On a CPU tensor it runs
    splat_io_probe_reference.
    """
    B, nb, P = _check_io_args(variant, iy, ix, ixy, g, H, W)
    if iy.device.type == "cpu":
        return splat_io_probe_reference(variant, iy, ix, ixy, g, H, W)
    sms = torch.cuda.get_device_properties(iy.device).multi_processor_count
    plan = io_launch_plan(variant, B, nb, P, H, W, sms)
    out = torch.empty((B, H, W * C), dtype=torch.float32, device=iy.device)
    for name, t in (("iy", iy), ("ix", ix), ("ixy", ixy), ("g", g), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the vector accesses")
    scratch = torch.empty(max(plan.scratch_floats, 1), dtype=torch.float32,
                          device=iy.device)
    rc = _lib().splat_io_probe(
        IO_VARIANTS.index(variant), iy.data_ptr(), ix.data_ptr(), ixy.data_ptr(),
        g.data_ptr(), out.data_ptr(), scratch.data_ptr(), _ticket(iy.device).data_ptr(),
        B, nb, P, H, W, plan.ctas, plan.blocks_per_cta, plan.zero_quads,
        plan.corner_rows, plan.corner_cols, plan.corner_quads, plan.width,
        plan.epilogue_quads, plan.scratch_floats,
        torch.cuda.current_stream(iy.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"splat_io_probe ({variant}) launch failed with CUDA error {rc}")
    splat_io_probe.launches += 1
    return out


splat_io_probe.launches = 0
