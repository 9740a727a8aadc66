"""The splat probes P1 and P2 (kernels/splat_probes.py) against the bodies
of the TPU probe kernels.

scripts/profile_splat.py and scripts/profile_splat_io.py only time their
kernels, so the kernel bodies are copied here and run through
pl.pallas_call(..., interpret=True) with the scripts' grid specs, as
nerf_from_image_tpu/ops/pallas/splat.py runs on the CPU. The port's plain
versions get the same seeded numpy inputs at a small shape (B=1, H=W=32,
C=32, P=64, WY=16, WX=8, 4 blocks).

Tolerances, relative to max |out|: 1e-5 where both sides take the same
bf16 operands and differ only in the f32 summation order. z_only and
read_g: the scripts round each block's sum to bf16 (jnp.sum of a bf16
array), the port keeps it f32, so they differ by up to half a bf16 ulp of
each block sum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nerf_from_image_tpu_torch import profile_splat as ps
from nerf_from_image_tpu_torch.kernels import splat_probes as tp
from tests.test_torch_generator import release_memory  # noqa: F401

B, H, W, C = 1, 32, 32, 32
P, WY, WX, NBLOCKS = 64, 16, 8, 4
NBTOT = B * NBLOCKS


def _inputs(seed=0):
    """The scripts' draws, in their order, at the small shape."""
    rng = np.random.default_rng(seed)
    iy = rng.uniform(0, H - 1, (NBTOT, P)).astype(np.float32)
    ix = rng.uniform(0, W - 1, (NBTOT, P)).astype(np.float32)
    g = jnp.asarray(rng.standard_normal((NBTOT, P, C)).astype(np.float32)).astype(jnp.bfloat16)
    oy0 = rng.integers(0, (H - WY) // 8, NBTOT).astype(np.int32) * 8
    ox0 = rng.integers(0, (W - WX) // 4, NBTOT).astype(np.int32) * 4
    return iy, ix, g, oy0, ox0


def _torch_inputs(iy, ix, g, oy0, ox0):
    g_t = torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16)
    return (torch.from_numpy(oy0).reshape(B, NBLOCKS),
            torch.from_numpy(ox0).reshape(B, NBLOCKS),
            torch.from_numpy(iy).reshape(B, NBLOCKS, P),
            torch.from_numpy(ix).reshape(B, NBLOCKS, P),
            g_t.reshape(B, NBLOCKS, P, C))


def _run_bf16_exact(fn, *args):
    """fn(*args) compiled without XLA's excess precision: by default XLA:CPU
    may keep a bf16 product (Z = zx * gt) in f32 up to the matmul, where the
    written program, and the TPU, round it to bf16."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args))


def _p1_pallas(stage, iy, ix, g, oy0, ox0):
    """scripts/profile_splat.py::run's kernel (:49-131) and grid spec."""
    nblocks = NBLOCKS

    def kernel(oy0_ref, ox0_ref, ok_ref, iy_ref, ix_ref, g_ref, out_ref):
        b = pl.program_id(0)
        k = pl.program_id(1)

        @pl.when(k == 0)
        def _zero():
            out_ref[...] = jnp.zeros_like(out_ref)

        blk = b * nblocks + k
        oy0 = oy0_ref[blk]
        ox0 = ox0_ref[blk]
        iy = iy_ref[0]
        ix = ix_ref[0]
        g = g_ref[0]
        x0f = jnp.minimum(jnp.floor(ix), W - 2.0)
        y0f = jnp.minimum(jnp.floor(iy), H - 2.0)
        wy1 = iy - y0f
        wx1 = ix - x0f
        yl0 = y0f - oy0.astype(jnp.float32)
        xl0 = x0f - ox0.astype(jnp.float32)
        ylanes = jax.lax.broadcasted_iota(jnp.int32, (P, WY), 1).astype(jnp.float32)
        oy = jnp.maximum(0.0, 1.0 - jnp.abs(ylanes - yl0 - wy1)).astype(jnp.bfloat16)
        if stage == "oy_only":
            T = jax.lax.dot_general(oy, oy, dimension_numbers=(((0,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            out_ref[0, 0:WY, 0:WY] += T
            return
        if stage == "bf16build":
            lxs = (jax.lax.broadcasted_iota(jnp.int32, (P, WX * C), 1) // C).astype(jnp.bfloat16)
            xc = (xl0 + wx1).astype(jnp.bfloat16)
            zx = jnp.maximum(jnp.bfloat16(0.0), jnp.bfloat16(1.0) - jnp.abs(lxs - xc))
        else:
            lxs = (jax.lax.broadcasted_iota(jnp.int32, (P, WX * C), 1) // C).astype(jnp.float32)
            zx = jnp.maximum(0.0, 1.0 - jnp.abs(lxs - xl0 - wx1)).astype(jnp.bfloat16)
        if stage == "no_tile":
            Z = zx
        elif stage == "dottile":
            tilemat = (jax.lax.broadcasted_iota(jnp.int32, (C, WX * C), 1) % C
                       == jax.lax.broadcasted_iota(jnp.int32, (C, WX * C), 0)).astype(jnp.bfloat16)
            gt = jax.lax.dot_general(g, tilemat, dimension_numbers=(((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.bfloat16)
            Z = zx * gt
        else:
            gt = jnp.tile(g, (1, WX))
            Z = zx * gt
        if stage == "z_only":
            out_ref[0, 0:1, 0:WX * C] += jnp.sum(Z, axis=0, keepdims=True).astype(jnp.float32)
            return
        T = jax.lax.dot_general(oy, Z, dimension_numbers=(((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        if stage == "static_store":
            out_ref[0, 0:WY, 0:WX * C] += T
        else:
            row0 = pl.multiple_of(oy0, 8)
            lane0 = pl.multiple_of(ox0 * C, 128)
            out_ref[0, pl.ds(row0, WY), pl.ds(lane0, WX * C)] += T

    blockmap = lambda b, k, *_: (b * nblocks + k, 0, 0)  # noqa: E731
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(B, nblocks),
        in_specs=[pl.BlockSpec((1, P, 1), blockmap, memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, P, 1), blockmap, memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, P, C), blockmap, memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, H, W * C), lambda b, k, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM),
    )
    fn = pl.pallas_call(kernel, grid_spec=grid_spec, interpret=True,
                        out_shape=jax.ShapeDtypeStruct((B, H, W * C), jnp.float32))
    ok = jnp.ones((NBTOT,), jnp.int32)
    return _run_bf16_exact(fn, jnp.asarray(oy0), jnp.asarray(ox0), ok,
                           jnp.asarray(iy)[..., None], jnp.asarray(ix)[..., None], g)


def _p2_pallas(variant, iy2, ix2, g):
    """scripts/profile_splat_io.py::run's five kernels (:49-176)."""
    nblocks = NBLOCKS
    ixy = jnp.stack([jnp.asarray(iy2), jnp.asarray(ix2)], axis=1)  # [NB, 2, P]
    out_spec = pl.BlockSpec((1, H, W * C), lambda b, k: (b, 0, 0), memory_space=pltpu.VMEM)
    call = functools.partial(pl.pallas_call, grid=(B, nblocks), out_specs=out_spec,
                             out_shape=jax.ShapeDtypeStruct((B, H, W * C), jnp.float32),
                             interpret=True)

    def blockmap(b, k):
        return (b * nblocks + k, 0, 0)

    def zero_first(out_ref):
        @pl.when(pl.program_id(1) == 0)
        def _():
            out_ref[...] = jnp.zeros_like(out_ref)

    if variant == "empty":
        def kernel(out_ref):
            zero_first(out_ref)
            out_ref[0, 0:64, 0:2048] += 1.0

        return np.asarray(call(kernel, in_specs=[])())
    if variant == "read_g":
        def kernel(g_ref, out_ref):
            zero_first(out_ref)
            out_ref[0, 0:1, 0:C] += jnp.sum(g_ref[0], axis=0, keepdims=True).astype(jnp.float32)

        return np.asarray(call(kernel, in_specs=[
            pl.BlockSpec((1, P, C), blockmap, memory_space=pltpu.VMEM)])(g))
    if variant == "read_ixy_P1":
        def kernel(iy_ref, ix_ref, out_ref):
            zero_first(out_ref)
            s = jnp.sum(iy_ref[0] + ix_ref[0])
            out_ref[0, 0:1, 0:1] += s[None, None]

        spec = pl.BlockSpec((1, P, 1), blockmap, memory_space=pltpu.VMEM)
        return np.asarray(call(kernel, in_specs=[spec, spec])(
            jnp.asarray(iy2)[..., None], jnp.asarray(ix2)[..., None]))
    spec2 = pl.BlockSpec((1, 2, P), blockmap, memory_space=pltpu.VMEM)
    if variant == "read_ixy_2P":
        def kernel(ixy_ref, out_ref):
            zero_first(out_ref)
            s = jnp.sum(ixy_ref[0])
            out_ref[0, 0:1, 0:1] += s[None, None]
    else:
        def kernel(ixy_ref, out_ref):
            zero_first(out_ref)
            v = ixy_ref[0]  # [2, P]
            vt = v.T  # [P, 2]
            iy = vt[:, 0:1]
            ix = vt[:, 1:2]
            ylanes = jax.lax.broadcasted_iota(jnp.int32, (P, 64), 1).astype(jnp.float32)
            oy = jnp.maximum(0.0, 1.0 - jnp.abs(ylanes - iy))
            s = jnp.sum(oy + 0.0 * ix)
            out_ref[0, 0:1, 0:1] += s[None, None]
    return np.asarray(call(kernel, in_specs=[spec2])(ixy))


def _block_sum_bf16_tol(blocks):
    """Half a bf16 ulp (2^-9 relative) of every block's sum, added up."""
    return float(np.sum(np.max(np.abs(blocks), axis=-1))) * 2.0 ** -9


@pytest.mark.parametrize("stage", tp.STAGES)
def test_window_probe_matches_pallas_body(stage):
    iy, ix, g, oy0, ox0 = _inputs()
    want = _p1_pallas(stage, iy, ix, g, oy0, ox0)
    args = _torch_inputs(iy, ix, g, oy0, ox0)
    got = tp.splat_window_probe(*args, H, W, WY, WX, stage).numpy()
    assert got.shape == want.shape == (B, H, W * C)
    scale = np.max(np.abs(want))
    assert scale > 0
    tol = 1e-5 * scale
    if stage == "z_only":
        oyb, zx = tp._tents(args[0].reshape(-1), args[1].reshape(-1), args[2].reshape(NBTOT, P),
                            args[3].reshape(NBTOT, P), H, W, WY, WX, stage)
        z = tp._window_operand(zx, args[4].reshape(NBTOT, P, C), stage).float()
        tol = _block_sum_bf16_tol(z.sum(dim=1).numpy()[None]) + tol
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if stage == "static_store":
        assert np.all(got[:, WY:] == 0) and np.all(got[:, :, WX * C:] == 0)


@pytest.mark.parametrize("variant", tp.IO_VARIANTS)
def test_io_probe_matches_pallas_body(variant):
    iy, ix, g, _, _ = _inputs()
    want = _p2_pallas(variant, iy, ix, g)
    _, _, tiy, tix, tg = _torch_inputs(iy, ix, g, np.zeros(NBTOT, np.int32),
                                       np.zeros(NBTOT, np.int32))
    ixy = torch.stack((tiy, tix), dim=2).contiguous()
    got = tp.splat_io_probe(variant, tiy, tix, ixy, tg, H, W).numpy()
    assert got.shape == want.shape == (B, H, W * C)
    tol = 1e-5 * np.max(np.abs(want))
    if variant == "read_g":
        tol += _block_sum_bf16_tol(tg.float().sum(dim=2).numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_wrappers_take_the_plain_version_on_the_cpu_and_check_arguments():
    iy, ix, g, oy0, ox0 = _inputs(1)
    args = _torch_inputs(iy, ix, g, oy0, ox0)
    ixy = torch.stack((args[2], args[3]), dim=2).contiguous()
    before = (tp.splat_window_probe.launches, tp.splat_io_probe.launches)
    torch.testing.assert_close(
        tp.splat_window_probe(*args, H, W, WY, WX, "full"),
        tp.splat_window_probe_reference(*args, H, W, WY, WX, "full"), rtol=0, atol=0)
    torch.testing.assert_close(
        tp.splat_io_probe("read_g", args[2], args[3], ixy, args[4], H, W),
        tp.splat_io_probe_reference("read_g", args[2], args[3], ixy, args[4], H, W),
        rtol=0, atol=0)
    assert (tp.splat_window_probe.launches, tp.splat_io_probe.launches) == before
    with pytest.raises(ValueError):
        tp.splat_window_probe(*args, H, W, WY, WX, "no_such_stage")
    with pytest.raises(ValueError):
        tp.splat_window_probe(*args, H, W, 24, WX, "full")  # WY % 16
    with pytest.raises(TypeError):
        tp.splat_window_probe(*args[:4], args[4].float(), H, W, WY, WX, "full")
    with pytest.raises(ValueError):
        tp.splat_io_probe("read_g", args[2], args[3], ixy[:, :, :1], args[4], H, W)


# Every profile_splat P1 case, chip_smoke.py's small shape and its extra
# small-shape checks (WY=128, WX=48, a partly filled ring stage with a
# partial last slab).
_PLAN_SHAPES = sorted(
    {(c.variant, c.P, c.WY, c.WX) for c in ps.CASES if c.probe == "window"}
    | {(s, 64, 16, 8) for s in tp.STAGES}
    | {(s, P_, WY_, WX_) for s in tp.STAGES
       for P_, WY_, WX_ in ((64, 128, 4), (64, 16, 48), (192, 80, 20))})


@pytest.mark.parametrize("stage,P,WY,WX", _PLAN_SHAPES)
def test_window_launch_plan_covers_each_column_once(stage, P, WY, WX):
    plan = tp.window_launch_plan(stage, P, WY, WX)
    ncols = WY if stage == "oy_only" else WX * C
    covered = np.zeros(ncols, np.int64)
    for slab in range(plan.slabs):
        for warp in range(plan.warps):
            for j in range(plan.warp_cols // 8):
                col = (slab * plan.warps + warp) * plan.warp_cols + j * 8
                if col < ncols:  # the kernel leaves tiles past the window idle
                    covered[col:col + 8] += 1
    assert np.all(covered == 1)
    assert plan.smem_bytes <= tp.MAX_SMEM == 227 * 1024
    assert plan.accumulators <= tp.ACC_BUDGET


# Every profile_splat P2 case, chip_smoke.py's small shape and its edge
# shapes, as (variant, B, nblocks, P, H, W).
_IO_PLAN_SHAPES = sorted(
    {(c.variant, ps.B, ps.N // c.P, c.P, ps.H, ps.W) for c in ps.CASES if c.probe == "io"}
    | {(v, B, NBLOCKS, P, H, W) for v in tp.IO_VARIANTS}
    | {(v, *shape) for v in tp.IO_VARIANTS for shape in ps.IO_EDGE_SHAPES})


@pytest.mark.parametrize("sms", (132, 7))
@pytest.mark.parametrize("variant,b,nblocks,p,h,w", _IO_PLAN_SHAPES)
def test_io_launch_plan_covers_each_block_once(variant, b, nblocks, p, h, w, sms):
    """The kernel's index arithmetic (csrc/splat_probes.cu::io_probe_kernel)
    on the plan: each point block is walked by one CTA, each output quad
    written by one CTA, and each partial has its own slot in scratch that
    the last CTA reads."""
    plan = tp.io_launch_plan(variant, b, nblocks, p, h, w, sms)
    wq = w * C // 4
    plane = h * wq
    total = b * plane
    writes = np.zeros(total, np.int32)
    for cta in range(plan.ctas):
        writes[cta * plan.zero_quads:(cta + 1) * plan.zero_quads] += 1
    in_plane = np.arange(total) % plane
    if variant == "empty":
        cwq = plan.corner_cols // 4
        owned = (in_plane // wq < plan.corner_rows) & (in_plane % wq < cwq)
        writes[owned] = 0
        corner = b * plan.corner_rows * cwq
        assert plan.corner_quads <= tp.EMPTY_TILE_QUADS  # a CTA's registers
        quads = np.arange(min(plan.ctas * plan.corner_quads, corner))
        rows = quads // cwq
        np.add.at(writes, ((rows // plan.corner_rows) * h + rows % plan.corner_rows) * wq
                  + quads % cwq, 1)
        assert (plan.corner_rows, plan.corner_cols) == (min(h, 64), min(w * C, 2048))
    else:
        writes[in_plane < plan.epilogue_quads] = 1  # the last CTA's sums and zeros
        assert 4 * plan.epilogue_quads >= plan.width == (C if variant == "read_g" else 1)
        walked = np.zeros(b * nblocks, np.int32)
        slots = set()
        touched = {bb: [] for bb in range(b)}
        for cta in range(plan.ctas):
            k0, k1 = cta * plan.blocks_per_cta, min((cta + 1) * plan.blocks_per_cta, b * nblocks)
            assert k0 < k1  # no CTA without blocks
            walked[k0:k1] += 1
            for bb in range(k0 // nblocks, (k1 - 1) // nblocks + 1):
                slot = (cta + bb) * plan.width
                assert slot + plan.width <= plan.scratch_floats and slot not in slots
                slots.add(slot)
                touched[bb].append(cta)
        assert np.all(walked == 1)
        for bb, ctas in touched.items():  # the CTAs whose partials the last CTA adds
            lo = bb * nblocks // plan.blocks_per_cta
            hi = ((bb + 1) * nblocks - 1) // plan.blocks_per_cta
            assert ctas == list(range(lo, hi + 1))
        assert plan.scratch_floats % 4 == 0 and 4 * plan.scratch_floats <= tp.MAX_SMEM - 2048
    assert np.all(writes == 1)


def _tent_pair(iy, ix):
    """transpose_2P's per-point sum as the kernel takes it (tent_pair): the
    lanes floor(iy) and floor(iy) + 1 that lie in [0, 64), each
    max(0, 1 - |lane - iy|) + 0 * ix, the first lane's term first."""
    zero_x = 0.0 * ix
    f0 = torch.floor(iy)
    f1 = f0 + 1.0

    def term(lane):
        return torch.clamp_min(1.0 - torch.abs(lane - iy), 0.0) + zero_x

    def inside(lane):
        return (lane >= 0.0) & (lane < 64.0)

    s = torch.where(inside(f0), term(f0), torch.zeros_like(iy))
    return torch.where(inside(f1), s + term(f1), s)


def test_transpose_2p_two_lanes_give_the_dense_sum_bit_for_bit():
    rng = np.random.default_rng(3)
    special = np.array([0.0, 1.0, 7.0, 62.0, 63.0, 64.0, 65.0, 63.25, 63.5, 63.999996,
                        64.5, 100.0, 255.0, 0.25, 62.75, 31.0], np.float32)
    iy = torch.from_numpy(np.concatenate(
        [special, rng.uniform(0, 80, 4096).astype(np.float32)]))
    ix = torch.from_numpy(rng.uniform(0, 255, iy.shape[0]).astype(np.float32))
    lanes = torch.arange(64, dtype=torch.float32)
    dense = (torch.clamp_min(1.0 - torch.abs(lanes - iy[:, None]), 0.0)
             + 0.0 * ix[:, None]).sum(dim=-1)
    got = _tent_pair(iy, ix)
    assert torch.equal(got.view(torch.int32), dense.view(torch.int32))
    assert float(got[5]) == 0.0 and float(got[4]) == 1.0 and float(got[7]) == 0.75
    # The plain version sums the same per-point values.
    ixy = torch.stack((iy, ix)).reshape(1, 1, 2, -1)
    want = tp.splat_io_probe_reference("transpose_2P", iy.reshape(1, 1, -1), ix.reshape(1, 1, -1),
                                       ixy, torch.zeros((1, 1, iy.shape[0], C), dtype=torch.bfloat16),
                                       1, 1)[0, 0, 0]
    torch.testing.assert_close(got.sum(), want, rtol=1e-6, atol=0)
