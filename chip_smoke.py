#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (nerf_from_image_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; each raises on failure, so a run that exits 0 passed all of them:

 1. Environment: the card's name and power limit (nvidia-smi), the torch
    and CUDA versions, and the build of every kernel in csrc/ (one nvcc per
    source, all started together).
 2. The splat kernel (K1, csrc/splat.cu) against its plain PyTorch version
    on the card, at full width (B=4, 3 x 256^2 x 32 f32 planes, N =
    128*128*64 points): the coarse and the fine points of one bench render
    step with their gradients, as the render hands them over (ray grid,
    16x16x4 blocks); the coarse points with scattered points in some blocks
    (footprints too large for shared memory); the no-grid order of
    a padded chunk; and small edge cases (coordinates exactly +-1, outside
    [-1, 1], on the H-2/W-2 base cell; without a grid and as a ray grid
    that the blocks do not divide); the coarse points also in two smaller
    block shapes. Prints each case's misfit blocks and the bytes it
    reduced into L2, and times each; times the plain version and one
    `index_put_(accumulate=True)` call on the coarse points, and the
    coarse points' kernel also one call at a time at cold L2
    (profile_splat.device_ms).
 3. A small render on the card against the same render on the CPU, values
    and (ws, pose) gradients; a small 'vgg' loss (LPIPS on crop-augmented
    copies, one transform for both) on the card against the CPU, value
    and gradient w.r.t. the predicted image.
 4. The main path, with the splat kernel's launch count set to 0 first:
    the full-width render forward+backward of the bench model and step
    (B=4, 128^2 rays, 64 coarse + 64 fine samples, pairwise merge, splat
    backward, grads w.r.t. ws and pose; bench.bench_config, timed by
    bench.time_steps) in f32 and in bf16 plane tables,
    a 5-step 'mse' inversion at the same width, and a 5-step 'vgg'
    inversion (15 crop augmentations: LPIPS on 64 + 64 images of 128^2
    per step, random VGG16 features from a seed) with PSNR/SSIM/IoU of
    the render against the target before and after.
 5. The hybrid inversion (encoder first guess, PnP, refinement, metrics)
    at invert.py's defaults on one card: first, at full width, the MiT-B5
    bootstrap encoder (depths
    (3, 6, 40, 3), random weights from a seed) on the card against the
    same encoder on the CPU for one 128^2 image, and batched PnP on a
    synthetic coordinate map of known poses (B=8, 128^2, the 11 focal
    guesses of get_focal_guesses, compaction 8192: rotation error under
    0.1 degree, focal exact). Then the two splat calls of one refinement
    step from the first guess at B=8 (coarse and fine points, as the
    render hands them over) against the plain version, folded into the
    kernel line's errors. Then, with the splat kernel's launch count
    set to 0, on B=8 targets rendered by the generator from seeded latents
    at known poses, with their masks: invert.first_guess (encoder, PnP,
    split ws), the eval metrics (PSNR/SSIM/IoU/LPIPS/rotation error), 30
    'vgg' refinement steps (lr_gain_z 5), the metrics again, a render of
    the result with SDF normals and the coordinate map, and the
    InversionReport saved and loaded back; 60 splat launches expected
    (2 a step, none in the no-grad renders). Prints encoder ms/batch,
    PnP ms/batch, refine ms/step, eval ms/batch and peak memory.
 6. The inversion driver end to end, as a user runs it:
    nerf_from_image_tpu_torch.invert.main in this process, on reference
    `.pth` checkpoints written from the bench generator
    ({'model_ema': ...}) and the MiT-B5 encoder ({'model_coord': ...})
    under build/invert_drive/, on the synthetic dataset (16 images of
    128^2, batch 32 so 2 batches of 8, `--plane_splat true --query_chunk
    0`, otherwise the defaults: 30 'vgg' steps, lr_gain_z 5, 64+64
    samples). The splat kernel's launch count is set to 0 just before and
    read just after: 2 a refinement step, 120 for the run, none in the
    eval, TensorBoard or demo renders. The report must hold 16 finite
    rows per metric at steps 0 and 30; prints s/img, ms per batch by part
    (first guess, evals, refinement) and peak memory, all of this run,
    which nothing records. Then one `--inv_export_demo_sample --inv_steps
    5` run (10 launches) at the same B=8 shapes: the two splat calls of
    its first refinement step are held to the plain version, and its PNG
    must decode (zlib) to the grid of 8 rows of 6 panels of 128^2.
 7. The driving evaluation and demo end to end (eval_driving.main and
    demo_driving.main in this process, on phase 6's `.pth` checkpoints):
    under build/driving_drive/, data/driving_fixtures.py writes a nuScenes
    tree (1600x900 CAM_FRONT frames, 34,000-point LIDAR_TOP sweeps, 2 cars
    of ~450 and ~60 px in 2 views, a person, Mask-RCNN masks in the
    'labels' schema, the index) and a KITTI tree (1242x375, 120,000-point
    scans, the first two cars of the package's index); the PNG reader is
    timed on a frame. eval_driving on each tree at its defaults (128^2,
    'vgg', checkpoints 0/20/50, known-K PnP from the MiT-B5 encoder,
    composites; `--plane_splat true --query_chunk 0`), each path's splat
    launches set to 0 just before and read just after: 2 x 50 x the
    objects its report holds; the nuScenes run's first two splat calls
    (B=1) held to the plain version. Every report row finite but the
    KITTI random view's image columns (NaN), composites of 7 panels
    (nuScenes) and 6 (KITTI). Then demo_driving on the first frame, 5
    steps: 2 x 5 launches a car, a PNG of 6 panels a car. Prints
    s/object, ms per part and peak memory.
 8. GAN training end to end (train.main in this process), cell
    train-synthetic: the bench generator at full width (latent 512, 3
    planes 256^2 x 32, a 10-color palette, SDF) and the pose-conditioned
    discriminator at 128^2, `--dataset synthetic --resolution 128
    --batch_size 8 --path_length_regularization --plane_splat true` at the
    default `--query_chunk 131072`, f32 planes, `--iterations 10
    --sdf_pretrain_steps 20 --max_images 64 --display_every 10` under
    build/train_drive/; then `--dual_discriminator --augment_p 0.8
    --disable_stylegan_noise false --iterations 4` from scratch under
    build/train_drive_dual/ (the second discriminator, image and camera
    augmentation, StyleGAN noise). Each run's splat launches are set to 0
    just before and read just after, and must be 16 a G step (8 chunks x
    2 passes of the main render) exactly: 80 and 64; D steps and SDF
    pretraining launch none. The first G step's first two splat calls are
    held to the plain version. Every loss must be finite; the saved
    checkpoint_10.pth is read by utils/weights.load_reference_generator
    and rendered once. Prints im/s over the GAN loop (batch x iterations
    / wall time, as train.main prints it), G- and D-step ms (medians of
    gan.g_step and gan.d_step, each on the host clock between a device
    synchronize before and one after it: the wrappers add the only
    synchronizes of the loop), SDF-pretraining ms/step and each run's peak
    memory.
 9. Encoder distillation end to end (train_encoder.main in this
    process), cell train-encoder-synthetic: the full MiT-B5 bootstrap
    encoder distilled from phase 6's `.pth` bench generator, `--dataset
    synthetic --resolution 128 --batch_size 32` (the driver's default
    batch, the pairwise merge), 4 iterations, then a resume for 2 more
    and one more through `invert --inv_train_coord_only`, under
    build/encoder_drive/. Each run's splat launches are set to 0 just
    before and read just after, and must be 0 (the target render takes
    no gradient). Every loss finite, each run starting where the last
    ended; the checkpoint's 'model_coord' read by
    utils/weights.load_reference_encoder. Prints ms/step (median, each
    step between a synchronize before and one after it, the first apart),
    peak memory, the batch and the merge mode.
10. FID and the train-time evaluation, cell fid-eval: the full
    FIDInceptionV3 (random weights from a seed) on the card against the
    CPU for 2 images of 128^2 resized to 299^2; the Frechet distance of
    two 2048-d statistics (Inception activations of 64 and 96 images, in
    metrics/fid.py's FID_DTYPE) on the card against the CPU, with its gap
    to a float64 eigenvalue reference; then NFI_INCEPTION_WEIGHTS pointed
    at a pytorch-fid-named `.pth` of those weights under build/fid_drive/,
    and train.main (B=8, 2 iterations, one evaluation of 32 images) once
    plain (generation FID) and once with --use_encoder (the
    reconstruction scalars and FIDs, best_fid.json), each path's splat
    launches 16 a G step and none in the evaluation; and invert.main on
    phase 6's files with FID on (2 'vgg' steps, 8 launches), its report's
    fid_front and fid_random finite. Prints Inception ms per batch of 32,
    FID ms, evaluation ms, peak memory and the launches.
11. The splat probes (P1, P2; csrc/splat_probes.cu): every P1 stage and P2
    variant against its plain version at a small shape, every P1 stage at
    three more small shapes at the edges of its launch plan (8 row
    fragments, WX=48, a partial slab and a partly filled ring stage),
    every P2 variant at the edges of its launch plan
    (profile_splat.IO_EDGE_SHAPES), then each case of
    python -m nerf_from_image_tpu_torch.profile_splat at its full shape:
    checked against the plain version (P2: also two calls for equal
    bits), then driven as its own path (its wrapper's launch count set to
    0 just before, read just after) and timed both ways
    (profile_splat.time_case: each call alone at cold L2 with the host out
    of the way, and back to back), with its device activities (P2: one
    kernel and no memset a call), beside its plain version, its bound,
    its dense formulation's operation time (P1), the P2 output's zeroing
    alone, and, where one exists, one PyTorch call computing the same
    work (profile_splat.library_call). They run after the main path, so
    that no torch.profiler session precedes its timings.
12. The kernel summary line, the card line, and last the ok line.

Weights are random, drawn from fixed seeds. Needs one card; exits non-zero
without one, or when the package is not next to this file.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

BATCH, RES, SAMPLES = 4, 128, 64
PLANE_RES, PLANE_C = 256, 32
# H100 SXM data-sheet peaks (dense f32 outside the tensor cores, HBM3).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_REL_TOL = 1e-5  # f32 atomics reorder the sums from run to run
RENDER_REL_TOL = 1e-4  # card vs CPU: other exp/log and summation orders
# P1: identically rounded bf16 operands, only the f32 sum order differs
# (tensor cores, reductions). P2: f32 block sums and atomics.
WINDOW_PROBE_TOL = 1e-4
IO_PROBE_TOL = 1e-5
VGG_LOSS_TOL = 1e-4  # card vs CPU: cuDNN and CPU convolution sum orders
ENCODER_TOL = 1e-4  # card vs CPU, relative to the largest output value
HYBRID_BATCH = 8  # invert.py: batch_size // 4 of the default 32, one device
HYBRID_STEPS = 30  # invert.py's steps at inv_gain_z 5
DRIVE_IMAGES, DEMO_STEPS = 16, 5
# eval_driving.py's checkpoints: 50 refinement steps an object.
DRIVING_CHECKPOINTS = {0, 20, 50}
DRIVING_STEPS = max(DRIVING_CHECKPOINTS)
# Phase 7's trees at the datasets' camera sizes (data/driving_fixtures.py).
NUSC_SIZE, KITTI_SIZE = (1600, 900), (1242, 375)
NUSC_LIDAR_POINTS, KITTI_LIDAR_POINTS = 34000, 120000
PNP_ROT_TOL_DEG = 0.1
# Phase 8, train-synthetic: B=8 of the README's 32 (the pairwise merge's
# [B, 128, 128, 64, 64] all-pairs tensors are not chunked).
TRAIN_BATCH, TRAIN_ITERATIONS, TRAIN_PRETRAIN, TRAIN_IMAGES = 8, 10, 20, 64
DUAL_ITERATIONS = 4
# K1 launches of one G step's main render: 128^2 x 64 points a pass in
# chunks of 131072, 2 passes.
K1_PER_RENDER = 2 * (RES * RES * SAMPLES) // 131072
# Phase 9, train-encoder-synthetic: the driver's default batch, a few
# iterations, a resume for two more and one through the hand-over.
ENCODER_BATCH, ENCODER_MERGE = 32, "pairwise"
ENCODER_ITERATIONS, ENCODER_RESUME = 4, 2
# Phase 10, fid-eval: card vs CPU gates; the train runs' evaluation size.
INCEPTION_TOL = 1e-4  # relative to the largest activation
FID_TOL = 1e-6  # float64 on both sides
FID_IMAGES, FID_ITERATIONS, FID_INV_STEPS = 32, 2, 2
# Lines of the TPU kernels the probe kernels replace.
P1_KERNEL = "scripts/profile_splat.py:49"
P2_KERNELS = {"empty": 51, "read_g": 71, "read_ixy_P1": 95, "read_ixy_2P": 119,
              "transpose_2P": 145}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def rel_err(a, b):
    denom = float(b.abs().max()) + 1e-30
    return float((a - b).abs().max()), float((a - b).abs().max()) / denom


def k1_case(name, coords, g, H, W, img_shape=None, block_shape=None):
    """K1 on one input against its plain version: (abs err, rel err,
    stats) where stats = (misfit (block, plane) pairs, all pairs, bytes
    reduced into device memory) as the kernel counted them."""
    import torch

    from nerf_from_image_tpu_torch.kernels.splat import (
        SPLAT_BLOCK,
        splat3_backward,
        splat3_backward_reference,
    )

    stats = torch.zeros(3, dtype=torch.int64, device=g.device)
    got = splat3_backward(coords, g, H, W, img_shape, block_shape or SPLAT_BLOCK,
                          stats=stats)
    ref = splat3_backward_reference(coords, g, H, W)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, ref)
    misfit, pairs, reduced = (int(v) for v in stats.tolist())
    log(f"K1 {name}: B={g.shape[0]} N={g.shape[1]} planes 3x{H}x{W}x{g.shape[2]}, "
        f"grid {img_shape} blocks {block_shape or SPLAT_BLOCK}: max abs err {abs_err:.3e}, "
        f"max rel err {rel:.3e} (max |grad| {float(ref.abs().max()):.4f}); "
        f"misfit blocks {misfit}/{pairs} ({100 * misfit / max(pairs, 1):.3f}%), "
        f"{reduced / 1e9:.4f} GB reduced into L2")
    if not (torch.isfinite(ref).all() and rel < KERNEL_REL_TOL):
        raise AssertionError(f"K1 {name} disagrees with its plain version: {rel}")
    return abs_err, rel, (misfit, pairs, reduced)


def phase_kernel(dev, model):
    """K1 against its plain version: the coarse and fine points of a bench
    render step with their gradients, a misfit geometry, the no-grid order
    of a padded chunk, and edge cases; each timed, the coarse points also
    with the plain version and one index_put_ call."""
    import torch

    from nerf_from_image_tpu_torch.engine.render import RenderConfig, prepare_rays
    from nerf_from_image_tpu_torch.kernels.splat import (
        splat3_backward,
        splat3_backward_reference,
        splat_corners,
    )
    from nerf_from_image_tpu_torch.ops.sampling import compute_query_points_from_rays
    from nerf_from_image_tpu_torch.profile_splat import cuda_ms, device_ms
    from nerf_from_image_tpu_torch.profile_step import bench_poses, splat_calls

    cfg = RenderConfig(resolution=RES, depth_samples_per_ray=SAMPLES, scene_range=1.4,
                       query_chunk=None, plane_splat=True)
    calls = splat_calls(model, cfg, dev)
    # The coarse points are the stratified samples of the bench camera.
    o, d, near, far = prepare_rays(cfg, bench_poses(BATCH, dev),
                                   torch.full((BATCH,), 1.2, device=dev))
    pts, _ = compute_query_points_from_rays(o, d, near, far, SAMPLES)
    coarse_pts = pts.reshape(BATCH, -1, 3) / cfg.scene_range
    is_coarse = [bool(torch.allclose(c[0], coarse_pts)) for c in calls]
    if len(calls) != 2 or sorted(is_coarse) != [False, True]:
        raise AssertionError(f"expected one coarse and one fine splat call, got {is_coarse}")
    coarse, fine = (calls[0], calls[1]) if is_coarse[0] else (calls[1], calls[0])
    del calls, pts, coarse_pts
    coords, g, H, W, grid, block = coarse
    if grid != (RES, RES, SAMPLES):
        raise AssertionError(f"the render handed the op the grid {grid}")
    N = coords.shape[1]

    # Scattered points in the first slab of the first tile row: 8 blocks
    # per batch element whose footprints cannot fit the window.
    gen = torch.Generator(device=dev).manual_seed(1)
    misfit = coords.clone().reshape(BATCH, RES, RES, SAMPLES, 3)
    misfit[:, :16, :, :4] = torch.rand((BATCH, 16, RES, 4, 3), generator=gen,
                                       device=dev) * 2.0 - 1.0
    misfit = misfit.reshape(BATCH, N, 3)
    # The points of a render chunked at 100,000 points: padded with zero
    # points (and zero gradients) to 11 chunks, handed over with no grid.
    pad = 11 * 100_000 - N
    padded = torch.cat((coords, coords.new_zeros(BATCH, pad, 3)), dim=1)
    padded_g = torch.cat((g, g.new_zeros(BATCH, pad, PLANE_C)), dim=1)
    cases = {
        "coarse": (coords, g, H, W, grid, block),
        "fine": fine,
        "misfit": (misfit, g, H, W, grid, block),
        "no_grid": (padded, padded_g, H, W, None, block),
    }
    # Smaller blocks than the default: two CTAs share an SM.
    for other in ((16, 8, 4), (8, 8, 4)):
        cases["coarse, blocks " + "x".join(map(str, other))] = (coords, g, H, W, grid, other)

    # Edge cases on a small plane: exact +-1, outside the box, base cell;
    # without a grid, then as a ray grid that no block shape divides.
    h = w = 16
    base = (h - 2) / (h - 1) * 2.0 - 1.0
    special = torch.tensor(
        [[1.0, -1.0, 0.3], [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0],
         [-1.0, -1.0, -1.0], [1.5, -2.0, 0.0], [-1.7, 3.0, 1.2],
         [base, base, base], [base, 1.0, 0.999], [0.999, base, -0.999]],
        device=dev,
    )
    rand = torch.rand((2, 501, 3), generator=gen, device=dev) * 2.4 - 1.2
    edge = torch.cat((special.expand(2, -1, -1), rand), dim=1).contiguous()
    ge = torch.randn((2, edge.shape[1], PLANE_C), generator=gen, device=dev)
    max_abs, max_rel = 0.0, 0.0
    for name, grid_e in (("edge cases", None), ("edge cases, ragged grid", (5, 6, 17))):
        a, r, _ = k1_case(name, edge, ge, h, w, grid_e, (4, 4, 4) if grid_e else None)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)

    results = {}
    for name, (c, gc, hh, ww, gr, bl) in cases.items():
        a, r, (n_mis, n_pairs, reduced) = k1_case(name, c, gc, hh, ww, gr, bl)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        ms = cuda_ms(lambda: splat3_backward(c, gc, hh, ww, gr, bl), iters=20, warmup=3)
        results[name] = {"ms": ms, "l2_reduction_bytes": reduced,
                         "misfit_share": n_mis / max(n_pairs, 1), "max_rel_err": r}
        log(f"K1 {name}: {ms:.4f} ms per launch")

    # The one-call yardstick on the coarse points: index_put_(accumulate=
    # True) of the same corners (indices and weighted rows made untimed).
    ref = splat3_backward_reference(coords, g, H, W)
    idx, vals = splat_corners(coords, g, H, W)
    lib_out = torch.zeros(BATCH * 3 * H * W, PLANE_C, device=dev)
    lib_out.index_put_((idx,), vals, accumulate=True)
    _, rel_lib = rel_err(lib_out.reshape(ref.shape), ref)
    log(f"index_put_ yardstick vs plain version: max rel err {rel_lib:.3e}")
    if not rel_lib < KERNEL_REL_TOL:
        raise AssertionError(f"the yardstick computes another function: {rel_lib}")
    del ref
    plain_ms = cuda_ms(lambda: splat3_backward_reference(coords, g, H, W), iters=3)
    library_ms = cuda_ms(
        lambda: lib_out.index_put_((idx,), vals, accumulate=True), iters=3
    )
    del idx, vals, lib_out

    n_bytes = 4 * (BATCH * N * 3 + BATCH * N * PLANE_C + 3 * BATCH * H * W * PLANE_C)
    n_ops = BATCH * N * 3 * 4 * PLANE_C * 2  # weight x g, accumulate
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_FLOPS * 1e3
    kernel_ms = results["coarse"]["ms"]
    cold_ms = device_ms(lambda: splat3_backward(coords, g, H, W, grid, block))
    log(f"K1 times (coarse points): kernel {kernel_ms:.4f} ms (each call alone at cold L2: "
        f"{cold_ms:.4f} ms), plain {plain_ms:.3f} ms, "
        f"index_put_ {library_ms:.3f} ms; bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({n_bytes / 1e9:.3f} GB -> {bytes_ms:.4f} ms, "
        f"{n_ops / 1e9:.2f} GFLOP f32 -> {ops_ms:.4f} ms), "
        f"{100 * max(bytes_ms, ops_ms) / kernel_ms:.1f}% of bound")
    torch.cuda.empty_cache()
    return {
        "name": "splat3_backward",
        "route": "cuda",
        "source": "nerf_from_image_tpu_torch/csrc/splat.cu",
        "replaces": "nerf_from_image_tpu/ops/pallas/splat.py:88",
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "cold_ms": cold_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "dense_product_ms": None,
        "l2_reduction_bytes": results["coarse"]["l2_reduction_bytes"],
        "misfit_share": results["coarse"]["misfit_share"],
        "cases": results,
    }


def tiny_generator(device, seed=0):
    from nerf_from_image_tpu_torch.models.generator import Generator
    import torch

    return Generator(
        latent_dim=64, scene_range=1.4, attention_values=4, use_sdf=True,
        w_dim=64, plane_channels=32, synthesis_resolution=64,
        channel_base=2048, channel_max=64, device=device,
        generator=torch.Generator().manual_seed(seed),
    )


def phase_small_render(dev):
    """A small splat render on the card against the same one on the CPU."""
    import torch

    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render

    # The box is pulled 1e-4 inside the generator's: on the box face itself
    # the out-of-box test of each ray's first sample flips with one ulp.
    cfg = RenderConfig(resolution=16, depth_samples_per_ray=8, query_chunk=None,
                       scene_range=1.4 * (1.0 - 1e-4), plane_splat=True)
    results = {}
    for device in ("cpu", dev):
        model = tiny_generator(device)
        # Random weights put the SDF far from 0; with beta = 0.1 the density
        # 0.5 * exp(-d / beta) is then a few ulps of laplace_cdf's 0.5 and
        # one-ulp exp differences between CPU and card dominate. beta = 1
        # keeps the density O(0.1) and the comparison well conditioned.
        with torch.no_grad():
            model.beta.fill_(1.0)
        pose = torch.eye(4, device=device)[None].clone()
        pose[:, 2, 3] = 2.5
        pose.requires_grad_(True)
        ws_np = np.random.default_rng(1).standard_normal((1, model.num_ws, 64))
        ws = torch.tensor(ws_np * 0.1, dtype=torch.float32, device=device,
                          requires_grad=True)
        out, _ = render(cfg, model, pose, torch.full((1,), 1.2, device=device),
                        ws, device=device)
        loss = torch.sum(out.rgb ** 2) + torch.sum(out.mask ** 2)
        gw, gp = torch.autograd.grad(loss, (ws, pose))
        results[str(device)] = [t.detach().cpu() for t in (out.rgb, out.mask, gw, gp)]
    for name, a, b in zip(("rgb", "mask", "d ws", "d pose"),
                          results[str(dev)], results["cpu"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"small render: non-finite {name}")
        _, rel = rel_err(a, b)
        log(f"small render card vs CPU: {name} max rel err {rel:.3e}")
        if not rel < RENDER_REL_TOL:
            raise AssertionError(f"small render {name} differs: {rel}")


def phase_small_vgg(dev):
    """A small 'vgg' reconstruction loss on the card against the CPU: the
    same LPIPS weights, images and augmentation transform."""
    import torch

    from nerf_from_image_tpu_torch.engine.augment import sample_transform
    from nerf_from_image_tpu_torch.engine.inversion import (
        InversionConfig,
        reconstruction_loss,
    )
    from nerf_from_image_tpu_torch.models.lpips import LPIPS

    cfg = InversionConfig(loss="vgg", num_augmentations=3)
    rng = np.random.default_rng(6)
    pred = rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    tform = sample_transform(torch.Generator().manual_seed(7), 6, 1.0)
    lpips = LPIPS(torch.Generator().manual_seed(8), device="cpu")
    results = {}
    for device in ("cpu", dev):
        x = torch.tensor(pred, device=device, requires_grad=True)
        loss = reconstruction_loss(
            cfg, lpips.to(device), x, torch.tensor(target, device=device),
            tform=type(tform)(*(t.to(device) for t in tform)))
        (grad,) = torch.autograd.grad(loss, x)
        results[str(device)] = (loss.detach().cpu(), grad.cpu())
    for name, a, b in zip(("loss", "d pred"), results[str(dev)], results["cpu"]):
        _, rel = rel_err(a, b)
        log(f"small vgg loss card vs CPU: {name} max rel err {rel:.3e}")
        if not (torch.isfinite(a).all() and rel < VGG_LOSS_TOL):
            raise AssertionError(f"small vgg loss {name} differs: {rel}")


def phase_probes(dev):
    """P1 and P2: small-shape and edge-shape checks, then every
    profile_splat case at full shape (check, counted timed run both ways,
    device activities, plain, bound, library call; P2 also the zeroing of
    its output alone and two calls' bits)."""
    import torch

    from nerf_from_image_tpu_torch import profile_splat as ps
    from nerf_from_image_tpu_torch.kernels import splat_probes as sp

    small = ps.ProbeInputs(dev, b=1, h=32, w=32, n=256)
    checks = [(small, c) for c in ([ps.Case("window", s, 64, 16, 8) for s in sp.STAGES]
                                   + [ps.Case("io", v, 64) for v in sp.IO_VARIANTS])]
    # P1's launch plan at its edges (window_launch_plan): 8 row fragments
    # (WY=128, WX=4: one slab of 4 warps); WX=48; 5 row fragments with a
    # ring stage that P=192 fills halfway (stages of 128) and a partial
    # last slab (WX=20: 640 columns in slabs of 256, so 4 of its 8 warps
    # idle; oy_only's 80 columns leave part of a warp's tiles idle).
    for inp, P, WY, WX in ((ps.ProbeInputs(dev, b=1, h=136, w=32, n=256), 64, 128, 4),
                           (ps.ProbeInputs(dev, b=1, h=32, w=64, n=256), 64, 16, 48),
                           (ps.ProbeInputs(dev, b=2, h=96, w=64, n=768), 192, 80, 20)):
        checks += [(inp, ps.Case("window", s, P, WY, WX)) for s in sp.STAGES]
    # P2's launch plan at its edges (io_launch_plan, profile_splat.IO_EDGE_SHAPES).
    for b, nb, P, h, w in ps.IO_EDGE_SHAPES:
        inp = ps.ProbeInputs(dev, b=b, h=h, w=w, n=nb * P)
        checks += [(inp, ps.Case("io", v, P)) for v in sp.IO_VARIANTS]
    for inp, case in checks:
        args = inp.args(case)
        _, rel = rel_err(ps.kernel_fn(case)(*args), ps.plain_fn(case)(*args))
        torch.cuda.synchronize()
        tol = WINDOW_PROBE_TOL if case.probe == "window" else IO_PROBE_TOL
        if not rel < tol:
            raise AssertionError(f"{case.name} at B={inp.B}, H={inp.H}, W={inp.W}, "
                                 f"N={inp.N}: rel err {rel}")
    log("splat probes at small shapes (B=1, H=W=32, P=64, WY=16, WX=8; P1 also "
        "at WY=128 WX=4, WX=48, and P=192 WY=80 WX=20; P2 also at (B, nblocks, P, "
        f"H, W) in {ps.IO_EDGE_SHAPES}): every P1 stage and P2 variant agrees with "
        "its plain version")

    inputs = ps.ProbeInputs(dev)
    zero = ps.zero_ms(inputs)
    log(f"torch.zeros of the P2 output [{inputs.B}, {inputs.H}, {inputs.W * PLANE_C}] f32: "
        f"{zero['zero_ms']:.4f} ms (old method {zero['zero_old_method_ms']:.4f} ms)")
    entries = []
    for case in ps.CASES:
        args = inputs.args(case)
        kernel, plain = ps.kernel_fn(case), ps.plain_fn(case)
        ref = plain(*args)
        got = kernel(*args)
        abs_err, rel = rel_err(got, ref)
        torch.cuda.synchronize()
        tol = WINDOW_PROBE_TOL if case.probe == "window" else IO_PROBE_TOL
        if not (torch.isfinite(ref).all() and rel < tol):
            raise AssertionError(f"{case.name} disagrees with its plain version: {rel}")
        if case.probe == "io":
            again = kernel(*args)
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"{case.name}: two calls differ in their bits")
            del again
        del got
        library = ps.library_call(case, inputs)
        # Where the library call gives the output itself, it must agree.
        same = {"z_only": lambda: ref[:, 0, :case.WX * PLANE_C],
                "read_g": lambda: ref[:, 0, :PLANE_C],
                "read_ixy_2P": lambda: ref[:, 0, 0]}.get(case.variant)
        if same is not None and not rel_err(library(), same())[1] < WINDOW_PROBE_TOL:
            raise AssertionError(f"{case.name}: the library call computes another function")
        del ref
        kernel.launches = 0  # this case's path starts here
        t = ps.time_case(case, inputs)
        launches = kernel.launches
        if launches == 0:
            raise AssertionError(f"{case.name}: its kernel was not launched")
        if case.probe == "io" and (len(t["activities"]) != 1
                                   or "memset" in t["activities"][0].lower()):
            raise AssertionError(f"{case.name}: a call is not one kernel and no memset: "
                                 f"{t['activities']}")
        plain_ms = ps.cuda_ms(lambda: plain(*args), iters=2, warmup=0)
        library_ms = None if library is None else ps.device_ms(library)
        del library
        b = ps.bound(case)
        dense = b["dense_product_ms"]
        zero_ms = zero["zero_ms"] if case.probe == "io" else None
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"{case.name}: kernel {t['ms']:.4f} ms (old method {t['old_method_ms']:.4f}; "
            f"last device activity {t['kernel_ms']:.4f}; activities of a call "
            f"{len(t['activities'])}: {', '.join(n[:40] for n in t['activities'])}; "
            f"{launches} launches; profiler sessions discarded "
            f"{len(t['discarded_sessions'])}: {t['discarded_sessions']}), plain "
            f"{plain_ms:.3f} ms, library {lib}"
            f"{'' if zero_ms is None else f', zero_ms {zero_ms:.4f}'}"
            f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes'] / 1e9:.4f} GB, "
            f"{b['ops'] / 1e9:.3f} GOP f32), {100 * b['bound_ms'] / t['ms']:.2f}% of bound"
            f"{'' if dense is None else f'; dense formulation {dense:.4f} ms'}"
            f"; max rel err {rel:.2e}")
        entries.append({
            "name": case.name,
            "route": "cuda",
            "source": "nerf_from_image_tpu_torch/csrc/splat_probes.cu",
            "replaces": (P1_KERNEL if case.probe == "window"
                         else f"scripts/profile_splat_io.py:{P2_KERNELS[case.variant]}"),
            "launches": launches,
            "max_abs_err": abs_err,
            "max_rel_err": rel,
            "ms": t["ms"],
            "old_method_ms": t["old_method_ms"],
            "kernel_ms": t["kernel_ms"],
            "discarded_sessions": t["discarded_sessions"],
            "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "dense_product_ms": dense,
            "library_ms": library_ms,
            **({} if zero_ms is None else {"zero_ms": zero_ms}),
        })
    del inputs
    torch.cuda.empty_cache()
    return entries


def phase_render(dev, model, plane_dtype, splat3_backward, steps=3):
    """Full-width render forward+backward at the bench step."""
    import torch

    from nerf_from_image_tpu_torch.bench import bench_config, result, time_steps
    from nerf_from_image_tpu_torch.profile_step import render_step

    cfg = bench_config(plane_dtype)
    step = render_step(model, cfg, dev)
    label = f"plane_dtype={plane_dtype}"
    torch.cuda.reset_peak_memory_stats()
    before = splat3_backward.launches
    loss, gw, gp = step()  # warm-up
    torch.cuda.synchronize()
    if splat3_backward.launches - before != 2:
        raise AssertionError(
            f"render step launched the splat kernel "
            f"{splat3_backward.launches - before} times, expected 2")
    for name, t in (("loss", loss), ("d ws", gw), ("d pose", gp)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{label}: non-finite {name}")
    times = time_steps(step, steps, dev)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    log(f"render fwd+bwd {label}: loss {float(loss.detach()):.4f}, "
        f"|d ws| {float(gw.norm()):.4e}, |d pose| {float(gp.norm()):.4e}; "
        f"step ms {', '.join(f'{t:.1f}' for t in times)} (median {ms:.1f}), "
        f"{json.dumps(result(times, BATCH, RES))}, "
        f"peak memory {peak / 2**30:.2f} GiB, splat launches per step 2")


def phase_inversion(dev, model, splat3_backward, steps=5):
    """A 5-step 'mse' inversion from average w and a perturbed pose, after
    a 1-step warm-up (the first optimizer step pays one-time set-up)."""
    import torch

    from nerf_from_image_tpu_torch.engine.render import RenderConfig
    from nerf_from_image_tpu_torch.profile_step import inversion_case

    cfg = RenderConfig(
        resolution=RES, depth_samples_per_ray=SAMPLES, fine_sampling=True,
        scene_range=1.4, query_chunk=None, plane_splat=True,
    )
    invert, z0, pose, target = inversion_case(model, cfg, dev, steps)
    invert(z0, pose, target.rgb, n_steps=1)
    before = splat3_backward.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, p_final, losses = invert(z0, pose, target.rgb)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = splat3_backward.launches - before
    losses = losses.cpu().tolist()
    log(f"inversion ({steps} steps, mse, B={BATCH}): losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}; {secs / steps * 1e3:.1f} ms/step; "
        f"splat launches {launches}")
    if launches != 2 * steps:
        raise AssertionError(f"inversion launched the kernel {launches} times")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"inversion loss did not fall: {losses}")
    if not (torch.isfinite(z).all() and torch.isfinite(p_final.q).all()):
        raise AssertionError("inversion returned non-finite parameters")


def image_metrics(model, cfg, z, params, target, dev):
    """PSNR, SSIM and IoU of the render at (z, pose params) against the
    target render (images mapped from [-1, 1] to [0, 1])."""
    import torch

    from nerf_from_image_tpu_torch.engine.inversion import InversionConfig, build_camera
    from nerf_from_image_tpu_torch.engine.render import render
    from nerf_from_image_tpu_torch.metrics.image import iou, psnr, ssim

    with torch.no_grad():
        cam, focal = build_camera(params, False)
        out, _ = render(cfg, model, cam, focal, z * InversionConfig.lr_gain_z, device=dev)
        a, b = (out.rgb + 1.0) / 2.0, (target.rgb + 1.0) / 2.0
        return (float(psnr(a, b)), float(ssim(a, b)),
                float(iou(out.mask.reshape(a.shape[:3]), target.mask.reshape(b.shape[:3]))))


def phase_vgg_inversion(dev, model, splat3_backward, steps=5):
    """A 5-step 'vgg' inversion (the default loss, 15 augmentations) at the
    bench width, after a 1-step warm-up."""
    import torch

    from nerf_from_image_tpu_torch.engine.render import RenderConfig
    from nerf_from_image_tpu_torch.models.lpips import LPIPS
    from nerf_from_image_tpu_torch.profile_step import inversion_case

    cfg = RenderConfig(
        resolution=RES, depth_samples_per_ray=SAMPLES, fine_sampling=True,
        scene_range=1.4, query_chunk=None, plane_splat=True,
    )
    lpips = LPIPS(torch.Generator().manual_seed(4), device=dev)
    invert, z0, pose, target = inversion_case(model, cfg, dev, steps, loss="vgg",
                                              lpips=lpips)
    before_metrics = image_metrics(model, cfg, z0, pose, target, dev)
    invert(z0, pose, target.rgb, n_steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = splat3_backward.launches
    t0 = time.perf_counter()
    z, p_final, losses = invert(z0, pose, target.rgb)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = splat3_backward.launches - before
    losses = losses.cpu().tolist()
    after_metrics = image_metrics(model, cfg, z, p_final, target, dev)
    log(f"inversion ({steps} steps, vgg, 15 augmentations, B={BATCH}): losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}; {secs / steps * 1e3:.1f} ms/step; "
        f"peak memory {peak / 2**30:.2f} GiB; splat launches {launches}; "
        f"PSNR/SSIM/IoU before {before_metrics[0]:.3f} dB/{before_metrics[1]:.4f}/"
        f"{before_metrics[2]:.4f}, after {after_metrics[0]:.3f} dB/{after_metrics[1]:.4f}/"
        f"{after_metrics[2]:.4f}")
    if launches != 2 * steps:
        raise AssertionError(f"vgg inversion launched the kernel {launches} times")
    if not np.isfinite(losses).all():
        raise AssertionError(f"vgg inversion losses are not finite: {losses}")
    if not (torch.isfinite(z).all() and all(torch.isfinite(t).all() for t in p_final
                                            if t is not None)):
        raise AssertionError("vgg inversion returned non-finite parameters")
    if not all(np.isfinite(before_metrics + after_metrics)):
        raise AssertionError("non-finite image metrics")


def synthetic_coordinate_maps(rng, batch, res, focal):
    """Coordinate maps of known cameras: each pixel of a centred disc
    (radius 0.45 of the image, ~10,300 pixels at 128^2, over the 8192-point
    compaction budget) holds the world point on its pixel-centre ray at a
    random depth in [2.5, 3.5]. Returns (coords [B, H, W, 3], masks
    [B, H, W] in {0, 1}, cam2world [B, 4, 4]) as float32 numpy, in
    pose/pnp.py's flipped-camera convention."""
    jj, ii = np.meshgrid(np.arange(res) / res - 0.5, np.arange(res) / res - 0.5,
                         indexing="ij")
    mask = (ii**2 + jj**2 < 0.45**2).astype(np.float32)
    coords = np.zeros((batch, res, res, 3), np.float32)
    cam2world = []
    for b in range(batch):
        R, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        t = np.array([0.1, -0.05, 3.0]) + rng.normal(0.0, 0.05, 3)
        z = rng.uniform(2.5, 3.5, (res, res))
        cam = np.stack((ii / focal * z, jj / focal * z, z), -1)
        coords[b] = (cam - t) @ R  # R^T (cam - t)
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, t
        w2c = np.diag([1.0, -1.0, -1.0, 1.0]) @ w2c
        cam2world.append(np.linalg.inv(w2c))
    masks = np.broadcast_to(mask, (batch, res, res)).copy()
    return coords, masks, np.stack(cam2world).astype(np.float32)


def last_and_median_ms(fn, dev, iters=3):
    """(fn's last result, median ms of `iters` calls) by bench.time_steps."""
    from nerf_from_image_tpu_torch.bench import time_steps

    out = []
    times = time_steps(lambda: out.append(fn()), iters, dev)
    return out[-1], float(np.median(times))


def phase_encoder(dev):
    """The full-width MiT-B5 bootstrap encoder on the card against the same
    weights on the CPU, one 128^2 image; returns the encoder on the card."""
    import torch

    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder

    encoder = BootstrapEncoder(512, device="cpu", generator=torch.Generator().manual_seed(9))
    encoder.requires_grad_(False)
    n_params = sum(p.numel() for p in encoder.parameters())
    x = torch.tensor(np.random.default_rng(10).uniform(-1.0, 1.0, (1, RES, RES, 3)),
                     dtype=torch.float32)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = encoder(x)
    cpu_s = time.perf_counter() - t0
    encoder.to(dev)
    with torch.no_grad():
        got = encoder(x.to(dev))
    for name, a, b in zip(("coords", "mask", "w"), got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"encoder on the card: non-finite {name}")
        abs_err, rel = rel_err(a.cpu(), b)
        log(f"encoder (MiT-B5, {n_params / 1e6:.1f} M parameters) card vs CPU: {name} "
            f"{tuple(a.shape)} max abs err {abs_err:.3e}, max rel err {rel:.3e}")
        if not rel < ENCODER_TOL:
            raise AssertionError(f"encoder {name} differs between card and CPU: {rel}")
    log(f"encoder on the CPU: {cpu_s:.1f} s for one image")
    return encoder


def phase_pnp(dev):
    """Batched PnP at full size on synthetic maps of known poses: B=8,
    128^2, the 11 default focal guesses, compaction 8192. Returns PnP
    ms/batch (median of 3)."""
    import torch

    from nerf_from_image_tpu_torch.pose.pnp import estimate_poses_batch, get_focal_guesses
    from nerf_from_image_tpu_torch.pose.pose import rotation_matrix_distance

    guesses = get_focal_guesses(np.linspace(1.0, 2.0, 200))
    if len(guesses) != 11:
        raise AssertionError(f"expected 11 focal guesses, got {guesses}")
    focal = float(np.float32(guesses[5]))
    coords, masks, cam2world = synthetic_coordinate_maps(np.random.default_rng(11),
                                                         HYBRID_BATCH, RES, focal)
    coords, masks = torch.from_numpy(coords).to(dev), torch.from_numpy(masks).to(dev)
    (cam, f, err), ms = last_and_median_ms(
        lambda: estimate_poses_batch(coords, masks, guesses), dev)
    rot = rotation_matrix_distance(cam, torch.from_numpy(cam2world).to(dev)).cpu()
    f = f.cpu()
    log(f"PnP (B={HYBRID_BATCH}, {RES}^2, {len(guesses)} focal guesses, "
        f"{int(masks[0].sum())} foreground pixels, compaction 8192): {ms:.2f} ms/batch; "
        f"rotation error max {float(rot.max()):.2e} deg, focal {f.tolist()} "
        f"(true {focal}), reprojection error max {float(err.max()):.2e}")
    if not (torch.isfinite(rot).all() and float(rot.max()) < PNP_ROT_TOL_DEG):
        raise AssertionError(f"PnP missed the synthetic poses: {rot.tolist()} deg")
    if not bool((f == focal).all()):
        raise AssertionError(f"PnP picked the focals {f.tolist()}, expected {focal}")
    return ms


def phase_hybrid(dev, model, encoder, splat3_backward):
    """The hybrid inversion at invert.py's defaults: first guess, eval,
    30 'vgg' steps, eval, a normals and coordinates render, the report.
    The splat calls of one refinement step from the first guess are held
    to the plain version first. Returns the splat launches of the counted
    path, the timings and those calls' K1 errors."""
    import torch

    from nerf_from_image_tpu_torch.engine import evaluate
    from nerf_from_image_tpu_torch.engine.inversion import (
        InversionConfig,
        build_camera,
        make_invert_fn,
    )
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.invert import first_guess
    from nerf_from_image_tpu_torch.models.lpips import LPIPS
    from nerf_from_image_tpu_torch.pose.pnp import estimate_poses_batch, get_focal_guesses
    from nerf_from_image_tpu_torch.profile_step import bench_poses, recorded_splat_calls

    B = HYBRID_BATCH
    cfg = RenderConfig(resolution=RES, depth_samples_per_ray=SAMPLES, fine_sampling=True,
                       scene_range=1.4, query_chunk=None, plane_splat=True)
    inv_cfg = InversionConfig(steps=HYBRID_STEPS, loss="vgg", lr_gain_z=5.0)
    lpips = LPIPS(torch.Generator().manual_seed(4), device=dev)
    guesses = get_focal_guesses(np.linspace(1.0, 2.0, 200))
    gen = torch.Generator(device=dev).manual_seed(12)
    pose_gt = bench_poses(B, dev)
    focal_gt = torch.full((B,), 1.2, device=dev)
    with torch.no_grad():
        z_true = torch.randn((B, model.latent_dim), generator=gen, device=dev)
        target_out, _ = render(cfg, model, pose_gt, focal_gt, z_true, device=dev)
        target = torch.cat((target_out.rgb, target_out.mask[..., None]), dim=-1)
        z_avg = model.average_w(generator=gen)
    del target_out
    invert = make_invert_fn(inv_cfg, cfg, model, lpips=lpips, device=dev)
    eval_fn = evaluate.make_eval_fn(inv_cfg, cfg, model, lpips, device=dev)
    maps_cfg = RenderConfig(resolution=RES, depth_samples_per_ray=SAMPLES, fine_sampling=True,
                            scene_range=1.4, query_chunk=None, plane_splat=True,
                            compute_normals=True, compute_coords=True)

    # The encoder and PnP alone, on these targets (timings; no splat).
    with torch.no_grad():
        (coords, mask, _), enc_ms = last_and_median_ms(lambda: encoder(target[..., :3]), dev)
    _, pnp_ms = last_and_median_ms(lambda: estimate_poses_batch(coords, mask, guesses), dev)
    log(f"encoder on the targets: {enc_ms:.1f} ms/batch (B={B}, {RES}^2); mask > 0.9 on "
        f"{float((mask > 0.9).float().mean()) * 100:.2f}% of pixels; "
        f"PnP {pnp_ms:.2f} ms/batch")
    del coords, mask
    # Warm-up: one refinement step (the first Adam step pays one-time
    # set-up) and one eval. The step's two splat calls, from the first
    # guess at B=8, are held to the plain version.
    z0, p0 = first_guess(encoder, target, z_avg, inv_cfg, guesses, device=dev)
    with recorded_splat_calls() as calls:
        invert(z0, p0, target, n_steps=1)
    if len(calls) != 2:
        raise AssertionError(f"a refinement step made {len(calls)} splat calls, expected 2")
    k1_errs = [k1_case(f"hybrid refinement step, call {i}", *call)[:2]
               for i, call in enumerate(calls)]
    del calls
    eval_fn(z0, p0, target, pose_gt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    splat3_backward.launches = 0  # this path starts here
    t = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        t.append(time.perf_counter())

    z0, p0 = first_guess(encoder, target, z_avg, inv_cfg, guesses, device=dev)
    mark()
    metrics0 = eval_fn(z0, p0, target, pose_gt)
    mark()
    z, p, losses = invert(z0, p0, target)
    mark()
    metrics = eval_fn(z, p, target, pose_gt)
    mark()
    with torch.no_grad():
        cam, focal = build_camera(p, inv_cfg.camera_flipped)
        maps, _ = render(maps_cfg, model, cam, focal, z * inv_cfg.lr_gain_z,
                         force_no_cam_grad=True, device=dev)
    mark()
    launches = splat3_backward.launches
    peak = torch.cuda.max_memory_allocated()
    first_ms, eval0_ms, refine_ms, eval_ms, maps_ms = (
        (b - a) * 1e3 for a, b in zip(t[:-1], t[1:]))

    report = evaluate.InversionReport(
        [0, HYBRID_STEPS], {"lpips": "(RANDOM-FEATURE — not metric grade)"})
    for step, m, zz, pp in ((0, metrics0, z0, p0), (HYBRID_STEPS, metrics, z, p)):
        report.add(step, m, {"ws": zz * inv_cfg.lr_gain_z, "R": pp.q, "s": pp.s, "t2": pp.t2})
    prefix = os.path.join(REPO, "build", "hybrid_report", "report")
    report.save(prefix)
    loaded = evaluate.InversionReport.load(prefix)
    if loaded.summary() != report.summary() or loaded.num_samples() != B:
        raise AssertionError("the saved inversion report does not load back")
    losses = losses.cpu().tolist()
    log(f"hybrid inversion (B={B}, {RES}^2, {SAMPLES}+{SAMPLES} samples, vgg, "
        f"{HYBRID_STEPS} steps, lr_gain_z {inv_cfg.lr_gain_z}): first guess "
        f"{first_ms:.1f} ms/batch (focals {p0.z0.exp().add(1).div(2).cpu().tolist()}), "
        f"refine {refine_ms / HYBRID_STEPS:.1f} ms/step, eval {(eval0_ms + eval_ms) / 2:.1f} "
        f"ms/batch, normals and coordinates render {maps_ms:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB; splat launches {launches}; losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}")
    for line in report.summary().splitlines():
        log(f"  report {line.strip()}")
    if launches != 2 * HYBRID_STEPS:
        raise AssertionError(f"the hybrid path launched the splat kernel {launches} times, "
                             f"expected {2 * HYBRID_STEPS}")
    for step, m in ((0, metrics0), (HYBRID_STEPS, metrics)):
        if set(m) != {"psnr", "ssim", "iou", "lpips", "rot_error"}:
            raise AssertionError(f"step {step} metrics: {sorted(m)}")
        for k, v in m.items():
            if v.shape != (B,) or not torch.isfinite(v).all():
                raise AssertionError(f"step {step} metric {k}: {v}")
    if not (np.isfinite(losses).all() and torch.isfinite(z).all()
            and all(torch.isfinite(x).all() for x in p if x is not None)):
        raise AssertionError("the hybrid inversion returned non-finite values")
    normal_len = maps.normals.norm(dim=-1)
    for name in ("rgb", "mask", "normals", "semantics"):
        if not torch.isfinite(getattr(maps, name)).all():
            raise AssertionError(f"normals render: non-finite {name}")
    if maps.normals.shape != (B, RES, RES, 3) or maps.semantics.shape != (B, RES, RES, 3):
        raise AssertionError("normals render: wrong map shapes")
    log(f"normals render: |normal| in [{float(normal_len.min()):.3f}, "
        f"{float(normal_len.max()):.3f}], coordinate map in "
        f"[{float(maps.semantics.min()):.3f}, {float(maps.semantics.max()):.3f}]")
    return {"launches": launches, "encoder_ms": enc_ms, "pnp_ms": pnp_ms,
            "first_guess_ms": first_ms, "refine_ms_per_step": refine_ms / HYBRID_STEPS,
            "eval_ms": (eval0_ms + eval_ms) / 2, "peak_gib": peak / 2**30,
            "k1_max_abs_err": max(a for a, _ in k1_errs),
            "k1_max_rel_err": max(r for _, r in k1_errs)}


def phase_invert_driver(dev, model, encoder, splat3_backward):
    """The inversion driver's main() on reference checkpoints of the bench
    generator and the encoder: the counted run (launches, s/img, peak
    memory) and its report, then a demo run, whose first refinement
    step's K1 calls are held to the plain version, and its PNG. Returns
    the launches by path, the timings and the K1 errors."""
    import shutil

    import torch

    from nerf_from_image_tpu_torch import invert
    from nerf_from_image_tpu_torch.profile_step import recorded_splat_calls
    from nerf_from_image_tpu_torch.utils.images import read_png

    root = os.path.join(REPO, "build", "invert_drive")
    shutil.rmtree(root, ignore_errors=True)  # no report checkpoint to resume
    os.makedirs(root)
    gen_path = os.path.join(root, "g_synthetic.pth")
    enc_path = os.path.join(root, "c_synthetic.pth")
    torch.save({"model_ema": {k: v.cpu() for k, v in model.state_dict().items()}}, gen_path)
    torch.save({"model_coord": {k: v.cpu() for k, v in encoder.state_dict().items()}},
               enc_path)
    argv = ["--dataset", "synthetic", "--resolution", str(RES), "--batch_size", "32",
            "--max_images", str(DRIVE_IMAGES), "--plane_splat", "true", "--query_chunk", "0",
            "--resume_from", gen_path, "--coord_resume_from", enc_path, "--root_path", root]
    os.environ.pop("NFI_INCEPTION_WEIGHTS", None)  # FID runs in phase 10
    cwd = os.getcwd()
    os.chdir(root)  # the demo composite goes to ./outputs/
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        splat3_backward.launches = 0  # this path starts here
        t0 = time.perf_counter()
        stats = invert.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = splat3_backward.launches
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()

        # The demo run's first refinement step (B=8, the counted run's
        # shapes) hands its two splat calls to the plain version; the
        # recorder carries the count over to splat3_backward on exit.
        splat3_backward.launches = 0  # the demo run's path starts here
        with recorded_splat_calls(limit=2) as calls:
            demo = invert.main(argv + ["--inv_export_demo_sample", "--inv_steps",
                                       str(DEMO_STEPS)])
        demo_launches = splat3_backward.launches
        grid = read_png(os.path.join(root, "outputs", f"sample_synthetic_{DEMO_STEPS}it.png"))
    finally:
        os.chdir(cwd)
    k1_errs = [k1_case(f"invert demo run, first refinement step, call {i}", *call)[:2]
               for i, call in enumerate(calls)]
    del calls

    steps = HYBRID_STEPS
    parts = {k: float(np.mean(v)) for k, v in stats["parts_ms"].items()}
    log(f"invert driver ({DRIVE_IMAGES} synthetic images of {RES}^2, batches of "
        f"{HYBRID_BATCH}, {steps} vgg steps, MiT-B5 first guess): {secs / DRIVE_IMAGES:.3f} "
        f"s/img ({secs:.1f} s in main, {stats['seconds']:.1f} s in its batch loop); per "
        f"batch: first guess {parts['first_guess']:.1f} ms, eval {parts['eval']:.1f} ms "
        f"(twice), refine {parts['refine']:.1f} ms ({parts['refine'] / steps:.1f} ms/step); "
        f"peak memory {peak / 2**30:.2f} GiB; splat launches {launches}; demo run "
        f"({DEMO_STEPS} steps) {demo['seconds']:.1f} s, {demo_launches} launches, PNG "
        f"{grid.shape}")
    if launches != 2 * steps * (DRIVE_IMAGES // HYBRID_BATCH):
        raise AssertionError(f"the driver launched the splat kernel {launches} times, "
                             f"expected {2 * steps * (DRIVE_IMAGES // HYBRID_BATCH)}")
    if demo_launches != 2 * DEMO_STEPS:
        raise AssertionError(f"the demo run launched the splat kernel {demo_launches} times")
    with np.load(os.path.join(stats["report_dir"], "report.npz")) as data:
        report = {k: data[k] for k in data.files}
    for step in (0, steps):
        names = {k.split("/", 1)[1] for k in report if k.startswith(f"step{step}/")}
        if not {"psnr", "ssim", "lpips", "rot_error", "ws", "R", "s", "t2"} <= names:
            raise AssertionError(f"step {step} of the report holds {sorted(names)}")
    for k, v in report.items():
        if k.startswith("step") and (len(v) != DRIVE_IMAGES or not np.isfinite(v).all()):
            raise AssertionError(f"report {k}: {v}")
    log("  report " + ", ".join(f"{k} {float(np.mean(v)):.4f}" for k, v in sorted(report.items())
                                if k.split("/")[-1] in ("psnr", "ssim", "lpips", "rot_error")))
    if grid.shape != (HYBRID_BATCH * RES, 6 * RES, 3):
        raise AssertionError(f"the demo PNG is {grid.shape}")
    return {"launches": launches, "demo_launches": demo_launches,
            "s_per_image": secs / DRIVE_IMAGES, "parts_ms": parts, "peak_gib": peak / 2**30,
            "k1_max_abs_err": max(a for a, _ in k1_errs),
            "k1_max_rel_err": max(r for _, r in k1_errs)}


def _finite_rows(report, n, nan_by_design=()):
    """Every stepN/ metric of a report holds n rows, finite but for the
    metrics named in nan_by_design, which are NaN."""
    for k, v in report.items():
        if not k.startswith("step"):
            continue
        name = k.split("/", 1)[1]
        want = np.isnan(v).all() if name in nan_by_design else np.isfinite(v).all()
        if v.shape != (n,) or not want:
            raise AssertionError(f"report {k}: {v}")


def phase_driving(gen_path, enc_path, splat3_backward):
    """The driving evaluation and demo end to end: eval_driving.main on a
    nuScenes and a KITTI tree (data/driving_fixtures.py) and demo_driving.main
    on one nuScenes frame, on the `.pth` checkpoints of phase 6. Each path's
    splat launch count is set to 0 just before its run and read just after
    (2 a refinement step); the nuScenes run's first two calls are held to
    the plain version. s/object is the object loop's time over its objects;
    main()'s set-up (checkpoint reads, encoder, LPIPS) is reported apart.
    Returns the launches by path, the timings, the K1 errors and the PNG
    reader's times."""
    import shutil

    import torch

    from nerf_from_image_tpu_torch import demo_driving, eval_driving
    from nerf_from_image_tpu_torch.data import driving_fixtures
    from nerf_from_image_tpu_torch.profile_step import recorded_splat_calls
    from nerf_from_image_tpu_torch.utils.images import read_png

    root = os.path.join(REPO, "build", "driving_drive")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    nusc = driving_fixtures.build_nusc_tree(os.path.join(root, "nusc"), *NUSC_SIZE,
                                            lidar_points=NUSC_LIDAR_POINTS,
                                            label_schema="labels")
    kitti = driving_fixtures.build_kitti_tree(os.path.join(root, "kitti"), width=KITTI_SIZE[0],
                                              height=KITTI_SIZE[1],
                                              lidar_points=KITTI_LIDAR_POINTS)
    log(f"driving trees: nuScenes {NUSC_SIZE[0]}x{NUSC_SIZE[1]}, {len(nusc['annotations'])} "
        f"annotations, {NUSC_LIDAR_POINTS} LiDAR points a sweep; KITTI {KITTI_SIZE[0]}x"
        f"{KITTI_SIZE[1]}, frame {kitti['frame']} objects {kitti['objects']}, "
        f"{KITTI_LIDAR_POINTS} points; written in {time.perf_counter() - t0:.1f} s")

    # The PNG reader on a frame of the nuScenes camera's size (host time):
    # filter 0 (this package's writer) and Paeth/Average rows (the
    # anti-diagonal decode).
    frame = os.path.join(root, "nusc", "samples", "CAM_FRONT", nusc["frames"][0])
    img = read_png(frame)
    filtered = os.path.join(root, "filtered.png")
    driving_fixtures.write_filtered_png(filtered, img, np.arange(img.shape[0]) % 5)
    png_ms = {}
    for name, path in (("filter 0", frame), ("all five filters", filtered)):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            got = read_png(path)
            times.append((time.perf_counter() - t) * 1e3)
        if not np.array_equal(got, img):
            raise AssertionError(f"the PNG reader decoded {name} wrongly")
        png_ms[name] = float(np.median(times))
    log(f"PNG reader, {img.shape[1]}x{img.shape[0]} RGB on this host: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in png_ms.items()))

    common = ["--resolution", str(RES), "--plane_splat", "true", "--query_chunk", "0",
              "--resume_from", gen_path, "--coord_resume_from", enc_path]
    runs = {
        "eval_driving_nusc": ["--dataset", "nusc", "--nusc_data_dir", os.path.join(root, "nusc"),
                              "--driving_index_file", nusc["index_file"]],
        "eval_driving_kitti": ["--dataset", "kitti", "--kitti_data_dir",
                               os.path.join(root, "kitti"), "--max_num_samples", "2"],
    }
    os.environ.pop("NFI_INCEPTION_WEIGHTS", None)
    cwd = os.getcwd()
    os.chdir(root)  # composites go to ./outputs/
    out, k1_errs = {}, []
    try:
        for path, argv in runs.items():
            argv = argv + common + ["--root_path", root, "--inv_export_demo_sample"]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            splat3_backward.launches = 0  # this path starts here
            t = time.perf_counter()
            if path == "eval_driving_nusc":
                # The first refinement step's two calls (B=1), cloned for
                # the check below.
                with recorded_splat_calls(limit=2) as calls:
                    stats = eval_driving.main(argv)
            else:
                stats = eval_driving.main(argv)
            torch.cuda.synchronize()
            out[path] = {"seconds": time.perf_counter() - t, "stats": stats,
                         "launches": splat3_backward.launches,
                         "peak": torch.cuda.max_memory_allocated()}
            torch.cuda.empty_cache()
        splat3_backward.launches = 0  # the demo's path starts here
        t = time.perf_counter()
        demo = demo_driving.main(["--dataset", "nusc", "--nusc_data_dir",
                                  os.path.join(root, "nusc"), "--inv_manual_input_path",
                                  nusc["frames"][0]] + common + ["--inv_steps", str(DEMO_STEPS)])
        torch.cuda.synchronize()
        demo_secs, demo_launches = time.perf_counter() - t, splat3_backward.launches
        demo_png = read_png(os.path.join(root, demo["output"]))
    finally:
        os.chdir(cwd)
    for i, call in enumerate(calls):
        k1_errs.append(k1_case(f"driving eval (nuScenes), first refinement step, call {i}",
                               *call)[:2])
    del calls
    if len(k1_errs) != 2:
        raise AssertionError(f"recorded {len(k1_errs)} splat calls of the nuScenes run")

    results = {"launches": {}, "png_reader_ms": png_ms}
    for path, run in out.items():
        stats, dataset = run["stats"], path.rsplit("_", 1)[1]
        n = stats["objects"]
        with np.load(os.path.join(stats["report_dir"], "report.npz")) as data:
            report = {k: data[k] for k in data.files}
        names = {k.split("/", 1)[1] for k in report if k.startswith("step")}
        want = {"psnr", "ssim", "lpips", "rot_error", "trans_error", "depth_error",
                "psnr_random", "ssim_random", "lpips_random", "depth_error_random"}
        checkpoints = {int(k[len("step"):].split("/")[0]) for k in report if k.startswith("step")}
        if names != want or checkpoints != DRIVING_CHECKPOINTS:
            raise AssertionError(f"{path}: report keys {sorted(report)}")
        nan = ("psnr_random", "ssim_random", "lpips_random") if dataset == "kitti" else ()
        _finite_rows(report, n, nan)
        if n == 0 or run["launches"] != 2 * DRIVING_STEPS * n:
            raise AssertionError(f"{path}: {run['launches']} splat launches for {n} objects, "
                                 f"expected {2 * DRIVING_STEPS * n}")
        panels = 7 if dataset == "nusc" else 6
        for i in range(n):
            png = read_png(os.path.join(root, "outputs", f"eval_{dataset}",
                                        f"demo_obj{i}_{DRIVING_STEPS}it.png"))
            if png.shape != (RES, panels * RES, 3):
                raise AssertionError(f"{path}: composite {i} is {png.shape}")
        parts = stats["parts_ms"]
        refine_ms_step = float(np.sum(parts["refine"])) / (n * DRIVING_STEPS)
        timing = {"s_per_object": stats["seconds"] / n, "main_s": run["seconds"],
                  "loop_s": stats["seconds"], "setup_s": run["seconds"] - stats["seconds"],
                  "data_ms": float(np.mean(parts["data"])),
                  "first_guess_ms": float(np.mean(parts["first_guess"])),
                  "eval_ms": float(np.mean(parts["eval"])),
                  "refine_ms_per_step": refine_ms_step, "peak_gib": run["peak"] / 2**30,
                  "objects": n}
        results[path] = timing
        results["launches"][path] = run["launches"]
        log(f"{path} ({n} objects, {RES}^2, vgg, {DRIVING_STEPS} steps (checkpoints "
            f"{sorted(checkpoints)}), MiT-B5 first guess, known-K PnP): "
            f"{timing['s_per_object']:.3f} s/object over its loop of {stats['seconds']:.1f} s; "
            f"set-up {timing['setup_s']:.1f} s ({run['seconds']:.1f} s in main); per "
            f"object: data {timing['data_ms']:.1f} ms, first guess "
            f"{timing['first_guess_ms']:.1f} ms, eval {timing['eval_ms']:.1f} ms per "
            f"checkpoint, refine {refine_ms_step:.1f} ms/step; peak memory "
            f"{timing['peak_gib']:.2f} GiB"
            + (" (with the two recorded splat calls' clones)" if dataset == "nusc" else "")
            + f"; splat launches {run['launches']}")
        log("  report " + ", ".join(
            f"{k} {float(np.mean(v)):.4f}" for k, v in sorted(report.items())
            if k.startswith(f"step{DRIVING_STEPS}/")))
        if dataset == "kitti":
            # From a random encoder's PnP pose the random view's render may
            # cover no reprojected LiDAR point: such a row is 0 and compares
            # nothing (the CPU parity test covers it from the true pose).
            empty = sum(int(np.sum(v == 0)) for k, v in report.items()
                        if k.endswith("/depth_error_random"))
            timing["random_depth_empty_rows"] = empty
            log(f"  random view: {empty} of {len(DRIVING_CHECKPOINTS) * n} depth_error_random "
                f"rows are 0 (no reprojected LiDAR point under the render)")
    n_cars = demo["cars"]
    if demo_launches != 2 * DEMO_STEPS * n_cars:
        raise AssertionError(f"the driving demo launched the splat kernel {demo_launches} "
                             f"times for {n_cars} cars")
    if demo_png.shape != (n_cars * RES, 6 * RES, 3):
        raise AssertionError(f"the driving demo's PNG is {demo_png.shape}")
    results["launches"]["driving_demo"] = demo_launches
    results["driving_demo"] = {"s_per_car": demo_secs / n_cars, "cars": n_cars}
    log(f"driving demo ({n_cars} cars, {DEMO_STEPS} steps): {demo_secs:.1f} s, "
        f"{demo_launches} splat launches, PNG {demo_png.shape}")
    results["k1_max_abs_err"] = max(a for a, _ in k1_errs)
    results["k1_max_rel_err"] = max(r for _, r in k1_errs)
    return results


def _timed(module, name, record):
    """Wraps module.<name> so that each call is timed on the host clock from
    a synchronize before it to one after it and appended to `record` as
    (ms, output). Returns a function that restores the original."""
    import torch

    original = getattr(module, name)

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t) * 1e3, out))
        return out

    setattr(module, name, call)
    return lambda: setattr(module, name, original)


def _timed_steps(gan):
    """Wraps gan.g_step, gan.d_step and gan.sdf_pretrain_step with _timed
    (train.main itself never synchronizes a step). Returns ({'g': [(ms,
    metrics)], 'd': [...], 'pretrain': [(ms, loss)]}, a function that
    restores the three)."""
    steps = {"g": [], "d": [], "pretrain": []}
    restores = [_timed(gan, name, steps[kind]) for kind, name in
                (("g", "g_step"), ("d", "d_step"), ("pretrain", "sdf_pretrain_step"))]

    def restore():
        for undo in restores:
            undo()

    return steps, restore


def _train_run(argv, splat3_backward, record=0):
    """train.main(argv), its splat launches counted alone, its peak memory,
    its steps timed (_timed_steps); with `record`, the first `record`
    splat calls (cloned)."""
    import contextlib

    import torch

    from nerf_from_image_tpu_torch import train
    from nerf_from_image_tpu_torch.engine import gan
    from nerf_from_image_tpu_torch.profile_step import recorded_splat_calls

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, restore = _timed_steps(gan)
    splat3_backward.launches = 0  # this path starts here
    recorder = recorded_splat_calls(limit=record) if record else contextlib.nullcontext([])
    t = time.perf_counter()
    try:
        with recorder as calls:
            stats = train.main(argv)
    finally:
        restore()
    torch.cuda.synchronize()
    stats["main_s"] = time.perf_counter() - t
    stats["launches"] = splat3_backward.launches
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["g_step_ms"] = [ms for ms, _ in steps["g"]]
    stats["d_step_ms"] = [ms for ms, _ in steps["d"]]
    stats["pretrain_ms"] = [ms for ms, _ in steps["pretrain"]]
    # Every step's metrics and every pretraining loss, read after the run.
    stats["losses"] = [{k: float(v) for k, v in m.items()}
                       for kind in ("g", "d") for _, m in steps[kind]]
    stats["losses"] += [{"sdf_pretrain_loss": float(loss)} for _, loss in steps["pretrain"]]
    torch.cuda.empty_cache()
    return stats, calls


def phase_train(dev, splat3_backward):
    """GAN training end to end, cell train-synthetic (see the module
    docstring): the counted runs, their timings, the K1 check of the first
    G step's calls, finite losses, and the checkpoint read back and
    rendered. Returns the launches by path, the timings and the K1 errors."""
    import shutil

    import torch

    from nerf_from_image_tpu_torch.data.configs import get_dataset_config
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.utils.weights import load_reference_generator

    os.environ.pop("NFI_INCEPTION_WEIGHTS", None)  # the evaluation runs in phase 10
    common = ["--dataset", "synthetic", "--resolution", str(RES), "--batch_size",
              str(TRAIN_BATCH), "--path_length_regularization", "--plane_splat", "true",
              "--max_images", str(TRAIN_IMAGES), "--sdf_pretrain_steps", str(TRAIN_PRETRAIN)]
    runs = {"train": (["--iterations", str(TRAIN_ITERATIONS), "--display_every",
                       str(TRAIN_ITERATIONS)], TRAIN_ITERATIONS),
            "train_dual": (["--iterations", str(DUAL_ITERATIONS), "--dual_discriminator",
                            "--augment_p", "0.8", "--disable_stylegan_noise", "false"],
                           DUAL_ITERATIONS)}
    results, k1_errs, launches = {}, [], {}
    for path, (extra, iterations) in runs.items():
        root = os.path.join(REPO, "build", path.replace("train", "train_drive"))
        shutil.rmtree(root, ignore_errors=True)  # from scratch: nothing to resume
        stats, calls = _train_run(common + extra + ["--root_path", root], splat3_backward,
                                  record=2 if path == "train" else 0)
        for i, call in enumerate(calls):
            k1_errs.append(k1_case(f"train, first G step, call {i}", *call)[:2])
        del calls
        per_render = K1_PER_RENDER * (2 if path == "train_dual" else 1)
        want = per_render * ((iterations + 1) // 2)
        if stats["launches"] != want:
            raise AssertionError(f"{path}: {stats['launches']} splat launches, expected {want}")
        bad = [(i, k, v) for i, m in enumerate(stats["losses"]) for k, v in m.items()
               if not np.isfinite(v)]
        if bad or len(stats["losses"]) != iterations + TRAIN_PRETRAIN:
            raise AssertionError(f"{path}: {len(stats['losses'])} steps, non-finite losses "
                                 f"{bad[:5]}")
        timing = {
            "img_per_s": TRAIN_BATCH * iterations / stats["seconds"],
            "g_step_ms": float(np.median(stats["g_step_ms"])),
            "d_step_ms": float(np.median(stats["d_step_ms"])),
            "first_g_step_ms": stats["g_step_ms"][0],
            "first_d_step_ms": stats["d_step_ms"][0],
            "pretrain_ms_per_step": float(np.median(stats["pretrain_ms"])),
            "loop_s": stats["seconds"], "main_s": stats["main_s"],
            "peak_gib": stats["peak_gib"], "iterations": iterations,
        }
        results[path] = timing
        launches[path] = stats["launches"]
        last = {k: round(v, 4) for k, v in {**stats["metrics"]["g"],
                                            **stats["metrics"]["d"]}.items()}
        log(f"{path} (B={TRAIN_BATCH}, {RES}^2, 64+64 samples, chunks of 131072, "
            f"{iterations} iterations after {TRAIN_PRETRAIN} SDF pretraining steps): "
            f"{timing['img_per_s']:.2f} im/s over the GAN loop of {stats['seconds']:.1f} s; "
            f"G step {timing['g_step_ms']:.1f} ms, D step {timing['d_step_ms']:.1f} ms "
            f"(medians; first {timing['first_g_step_ms']:.0f} / "
            f"{timing['first_d_step_ms']:.0f} ms), SDF pretraining "
            f"{timing['pretrain_ms_per_step']:.1f} ms/step; main() {stats['main_s']:.1f} s; "
            f"peak memory {timing['peak_gib']:.2f} GiB; splat launches {stats['launches']}")
        log(f"  last losses {last}")
        if path == "train":
            checkpoint = stats["last_checkpoint"]
    if not checkpoint.endswith(f"checkpoint_{TRAIN_ITERATIONS}.pth"):
        raise AssertionError(f"the run saved {checkpoint}")

    # The saved EMA generator, read as the inversion driver reads a
    # reference checkpoint, and rendered once.
    config = get_dataset_config("synthetic")
    model = Generator(latent_dim=512, scene_range=config.scene_range, attention_values=10,
                      use_sdf=True, device=dev)
    load_reference_generator(model, checkpoint)
    cam = torch.eye(4, device=dev)[None]
    cam[0, 2, 3] = 2.5
    with torch.no_grad():
        z = torch.randn((1, 512), generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev)
        out, _ = render(RenderConfig(resolution=RES, scene_range=config.scene_range,
                                     white_background=config.white_background),
                        model, cam, torch.full((1,), 1.5, device=dev), z, device=dev)
    if out.rgb.shape != (1, RES, RES, 3) or not torch.isfinite(out.rgb).all():
        raise AssertionError("the trained checkpoint rendered a non-finite image")
    log(f"checkpoint {os.path.relpath(checkpoint, REPO)}: read back, rendered "
        f"{tuple(out.rgb.shape)}, rgb in [{float(out.rgb.min()):.3f}, "
        f"{float(out.rgb.max()):.3f}], mask mean {float(out.mask.mean()):.3f}")
    del model
    torch.cuda.empty_cache()
    results["launches"] = launches
    results["k1_max_abs_err"] = max(a for a, _ in k1_errs)
    results["k1_max_rel_err"] = max(r for _, r in k1_errs)
    return results


def phase_train_encoder(gen_path, splat3_backward):
    """Encoder distillation end to end (train_encoder.main in this process),
    cell train-encoder-synthetic: the full MiT-B5 encoder distilled from
    phase 6's bench generator, a resume, the checkpoint read back, and the
    --inv_train_coord_only hand-over. Returns the launches by path and the
    timings."""
    import shutil

    import torch

    from nerf_from_image_tpu_torch import invert, train_encoder
    from nerf_from_image_tpu_torch.engine import coord_regressor
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    from nerf_from_image_tpu_torch.utils.checkpoint import load_train_checkpoint
    from nerf_from_image_tpu_torch.utils.weights import load_reference_encoder

    root = os.path.join(REPO, "build", "encoder_drive")
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--dataset", "synthetic", "--resolution", str(RES), "--batch_size",
            str(ENCODER_BATCH), "--merge_mode", ENCODER_MERGE, "--max_images",
            str(TRAIN_IMAGES), "--resume_from", gen_path, "--root_path", root]
    steps, launches, runs = [], {}, {}
    restore = _timed(coord_regressor, "coord_train_step", steps)
    try:
        for path, iterations, entry in (
                ("train_encoder", ENCODER_ITERATIONS, train_encoder.main),
                ("train_encoder_resume", ENCODER_ITERATIONS + ENCODER_RESUME,
                 train_encoder.main),
                ("invert_coord_only", ENCODER_ITERATIONS + ENCODER_RESUME + 1,
                 lambda a: invert.main(a + ["--inv_train_coord_only"]))):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            splat3_backward.launches = 0  # this path starts here
            run = entry(argv + ["--iterations", str(iterations)])
            torch.cuda.synchronize()
            launches[path] = splat3_backward.launches
            run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            runs[path] = run
    finally:
        restore()
    first, resumed, handed = (runs[k] for k in launches)
    want = [(0, ENCODER_ITERATIONS), (ENCODER_ITERATIONS, ENCODER_ITERATIONS + ENCODER_RESUME),
            (ENCODER_ITERATIONS + ENCODER_RESUME, ENCODER_ITERATIONS + ENCODER_RESUME + 1)]
    got = [(r["start_iteration"], r["iterations"]) for r in (first, resumed, handed)]
    if got != want:
        raise AssertionError(f"encoder runs (start, end) {got}, expected {want}")
    losses = [{k: float(v) for k, v in out.items()} for _, out in steps]
    bad = [(i, k, v) for i, m in enumerate(losses) for k, v in m.items() if not np.isfinite(v)]
    if bad or len(losses) != want[-1][1]:
        raise AssertionError(f"{len(losses)} encoder steps, non-finite losses {bad[:5]}")
    if any(launches.values()):
        raise AssertionError(f"encoder distillation launched the splat kernel: {launches}")

    # The checkpoint, read as the inversion driver reads a reference encoder.
    state = load_train_checkpoint(handed["last_checkpoint"])
    encoder = BootstrapEncoder(latent_dim=512, device="cuda",
                               generator=torch.Generator().manual_seed(3))
    load_reference_encoder(encoder, handed["last_checkpoint"])
    for k, v in encoder.state_dict().items():
        if not torch.equal(v.cpu(), state["model_coord"][k]):
            raise AssertionError(f"the encoder checkpoint's {k} did not load")
    if state["iteration"] != want[-1][1] or state["optimizer_coord"]["count"] != want[-1][1]:
        raise AssertionError(f"the checkpoint is at iteration {state['iteration']}")
    del encoder, state

    ms = [t for t, _ in steps]
    timing = {"ms_per_step": float(np.median(ms[1:ENCODER_ITERATIONS])),
              "resumed_ms_per_step": float(np.median(ms[ENCODER_ITERATIONS:])),
              "first_step_ms": ms[0], "peak_gib": first["peak_gib"],
              "batch": ENCODER_BATCH, "merge_mode": ENCODER_MERGE,
              "steps": len(ms), "loop_s": first["seconds"]}
    log(f"train_encoder (MiT-B5 from the bench generator, B={ENCODER_BATCH}, {RES}^2, 64+64 "
        f"samples, merge {ENCODER_MERGE}): {timing['ms_per_step']:.1f} ms/step (median of "
        f"steps 2-{ENCODER_ITERATIONS}; first {ms[0]:.0f} ms), resumed "
        f"{timing['resumed_ms_per_step']:.1f} ms/step; peak memory "
        f"{timing['peak_gib']:.2f} GiB; losses first {losses[0]} last {losses[-1]}; "
        f"splat launches {launches}")
    torch.cuda.empty_cache()
    return {"launches": launches, "timing": timing}


def phase_fid(dev, gen_path, splat3_backward):
    """FID and the train-time evaluation, cell fid-eval: the full Inception
    on the card against the CPU, the Frechet distance on the card against
    the CPU (and its gap to a float64 eigenvalue reference), then, with
    NFI_INCEPTION_WEIGHTS naming a pytorch-fid-named file of those random
    weights, train.main with one evaluation (plain, then --use_encoder)
    and invert.main with FID on phase 6's files. Returns the launches by
    path and the timings."""
    import copy
    import shutil

    import torch

    from nerf_from_image_tpu_torch import invert, train
    from nerf_from_image_tpu_torch.engine import gan, gan_eval
    from nerf_from_image_tpu_torch.metrics import fid
    from nerf_from_image_tpu_torch.models.inception import FIDInceptionV3

    root = os.path.join(REPO, "build", "fid_drive")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    inception = FIDInceptionV3(device=dev, generator=torch.Generator().manual_seed(11))
    x = torch.rand((2, RES, RES, 3), generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        got = inception(x.to(dev)).cpu()
        want = copy.deepcopy(inception).cpu()(x)
    inc_abs, inc_rel = rel_err(got, want)
    log(f"FIDInceptionV3 (random weights, 2 images of {RES}^2 resized to 299^2): card vs CPU "
        f"max abs err {inc_abs:.3e}, rel {inc_rel:.3e} of the largest activation "
        f"{float(want.abs().max()):.3e}")
    if not inc_rel < INCEPTION_TOL:
        raise AssertionError(f"Inception card vs CPU: {inc_rel:.3e}")
    batch = torch.rand((32, RES, RES, 3), generator=torch.Generator().manual_seed(13),
                       device="cpu").to(dev)
    with torch.no_grad():
        inception_ms = last_and_median_ms(lambda: inception(batch), dev, iters=5)[1]

    # Two 2048-d statistics of Inception activations (64 and 96 images:
    # both covariances singular), in the drivers' dtype.
    draw = torch.Generator(device=dev).manual_seed(14)
    with torch.no_grad():
        acts = [inception(torch.rand((n, RES, RES, 3), generator=draw, device=dev) * scale
                          + shift)
                for n, scale, shift in ((64, 1.0, 0.0), (96, 0.6, 0.2))]
    stats = [fid.calculate_stats(a.to(fid.FID_DTYPE)) for a in acts]
    on_card = float(fid.frechet_distance(*stats[0], *stats[1]))
    fid_ms = last_and_median_ms(lambda: fid.frechet_distance(*stats[0], *stats[1]), dev,
                                iters=3)[1]
    cpu_stats = [tuple(t.cpu() for t in st) for st in stats]
    t = time.perf_counter()
    on_cpu = float(fid.frechet_distance(*cpu_stats[0], *cpu_stats[1]))
    cpu_s = time.perf_counter() - t
    (m1, s1), (m2, s2) = ([t.numpy() for t in st] for st in cpu_stats)
    eye = 1e-6 * np.eye(len(m1))
    e2, v2 = np.linalg.eigh(s2 + eye)
    half = (v2 * np.sqrt(np.clip(e2, 0, None))) @ v2.T
    tr = float(np.sum(np.sqrt(np.clip(np.linalg.eigvalsh(half @ (s1 + eye) @ half), 0, None))))
    reference = float(np.sum((m1 - m2) ** 2) + np.trace(s1) + np.trace(s2) - 2 * tr)
    fid_gate = abs(on_card - on_cpu) / max(abs(on_cpu), 1e-12)
    log(f"Frechet distance (2048-d, 64 vs 96 images, {fid.FID_DTYPE}): card {on_card:.6f}, "
        f"CPU {on_cpu:.6f} (rel {fid_gate:.3e}; {cpu_s:.1f} s), float64 eigenvalue "
        f"reference {reference:.6f} (gap {abs(on_card - reference):.3e}); card "
        f"{fid_ms:.1f} ms; Inception {inception_ms:.1f} ms per batch of 32 at {RES}^2")
    if not (np.isfinite(on_card) and fid_gate < FID_TOL):
        raise AssertionError(f"FID card {on_card} vs CPU {on_cpu}")
    weights = os.path.join(root, "pt_inception.pth")
    state = {k: v.cpu() for k, v in inception.state_dict().items()}
    state.update({"fc.weight": torch.zeros((1008, 2048)), "fc.bias": torch.zeros(1008)})
    torch.save(state, weights)
    del inception, acts, stats, batch, state
    torch.cuda.empty_cache()

    os.environ["NFI_INCEPTION_WEIGHTS"] = weights
    launches, results, evals = {}, {}, []
    make = train.make_train_eval

    def timed_eval(*args, **kwargs):
        evaluate = make(*args, **kwargs)

        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = evaluate()
            torch.cuda.synchronize()
            evals.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    train.make_train_eval = timed_eval
    g_steps = []
    restore_g = _timed(gan, "g_step", g_steps)
    try:
        common = ["--dataset", "synthetic", "--resolution", str(RES), "--batch_size",
                  str(TRAIN_BATCH), "--plane_splat", "true", "--max_images", str(FID_IMAGES),
                  "--sdf_pretrain_steps", "2", "--iterations", str(FID_ITERATIONS),
                  "--display_every", str(FID_ITERATIONS)]
        for path, extra in (("train_fid", []), ("train_use_encoder", ["--use_encoder"])):
            run_root = os.path.join(root, path)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            del g_steps[:]
            splat3_backward.launches = 0  # this path starts here
            t = time.perf_counter()
            run = train.main(common + extra + ["--root_path", run_root])
            torch.cuda.synchronize()
            launches[path] = splat3_backward.launches
            n_g = len(g_steps)
            if launches[path] != K1_PER_RENDER * n_g or n_g != (FID_ITERATIONS + 1) // 2:
                raise AssertionError(f"{path}: {launches[path]} splat launches in {n_g} G "
                                     f"steps, expected {K1_PER_RENDER} a G step")
            scalars = run["eval"]
            if not all(np.isfinite(v) for v in scalars.values()):
                raise AssertionError(f"{path}: evaluation {scalars}")
            if path == "train_use_encoder":
                names = {k for k in scalars if k.startswith("reconstruction/")}
                need = {f"reconstruction/{m}{s}_front" for m in ("psnr", "ssim", "lpips")
                        for s in ("", "_test")} | {
                    f"reconstruction/fid_{v}view{s}" for v in ("front", "random")
                    for s in ("", "_test")}
                best = os.path.join(run["checkpoint_dir"], "best_fid.json")
                if names != need or not os.path.exists(best):
                    raise AssertionError(f"{path}: scalars {sorted(names)}")
            else:
                if set(scalars) != {"fid", "generation/fid_untrunc"}:
                    raise AssertionError(f"{path}: scalars {sorted(scalars)}")
            results[path] = {"eval_ms": evals[-1], "main_s": time.perf_counter() - t,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "fid": scalars["fid"], "g_steps": n_g}
            log(f"{path} (B={TRAIN_BATCH}, {FID_IMAGES} eval images of {RES}^2, "
                f"{FID_ITERATIONS} iterations, one evaluation): evaluation "
                f"{evals[-1]:.0f} ms, FID {scalars['fid']:.4f}; main() "
                f"{results[path]['main_s']:.1f} s; peak memory "
                f"{results[path]['peak_gib']:.2f} GiB; splat launches {launches[path]}")
            log("  " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(scalars.items())))
    finally:
        restore_g()
        train.make_train_eval = make

    # The inversion driver with FID, on phase 6's files.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    splat3_backward.launches = 0  # this path starts here
    t = time.perf_counter()
    stats = invert.main(["--dataset", "synthetic", "--resolution", str(RES), "--batch_size",
                         "32", "--max_images", str(DRIVE_IMAGES), "--plane_splat", "true",
                         "--query_chunk", "0", "--inv_steps", str(FID_INV_STEPS),
                         "--resume_from", gen_path, "--root_path", os.path.join(root, "inv")])
    torch.cuda.synchronize()
    launches["invert_fid"] = splat3_backward.launches
    want = 2 * FID_INV_STEPS * (DRIVE_IMAGES // HYBRID_BATCH)
    if launches["invert_fid"] != want:
        raise AssertionError(f"invert with FID: {launches['invert_fid']} launches, want {want}")
    with open(os.path.join(stats["report_dir"], "report.txt")) as f:
        fids = [float(line.split(": ")[1]) for line in f if line.strip().startswith("fid_")]
    if len(fids) != 4 or not np.isfinite(fids).all():
        raise AssertionError(f"the inversion report's FIDs: {fids}")
    results["invert_fid"] = {"main_s": time.perf_counter() - t, "fids": fids,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"invert with FID ({DRIVE_IMAGES} images, {FID_INV_STEPS} vgg steps): report "
        f"fid_front/fid_random at steps 0 and {FID_INV_STEPS} {fids}; main() "
        f"{results['invert_fid']['main_s']:.1f} s; peak memory "
        f"{results['invert_fid']['peak_gib']:.2f} GiB; splat launches {launches['invert_fid']}")
    os.environ.pop("NFI_INCEPTION_WEIGHTS")
    torch.cuda.empty_cache()
    results.update({"inception_rel_err": inc_rel, "inception_ms_per_32": inception_ms,
                    "fid_ms": fid_ms, "fid_card_vs_cpu": fid_gate,
                    "fid_float64_gap": abs(on_card - reference)})
    return {"launches": launches, "timing": results}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "nerf_from_image_tpu_torch")):
        print("chip_smoke: nerf_from_image_tpu_torch/ is not next to this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from nerf_from_image_tpu_torch.kernels import build
    from nerf_from_image_tpu_torch.kernels.splat import splat3_backward
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.utils.device import set_strict_f32

    dev = torch.device("cuda")
    set_strict_f32()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")

    model = Generator(latent_dim=512, scene_range=1.4, attention_values=10,
                      use_sdf=True, device=dev,
                      generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    summary = phase_kernel(dev, model)
    phase_small_render(dev)
    phase_small_vgg(dev)

    splat3_backward.launches = 0  # the render and inversion path starts here
    phase_render(dev, model, "float32", splat3_backward)
    phase_render(dev, model, "bfloat16", splat3_backward)
    phase_inversion(dev, model, splat3_backward)
    phase_vgg_inversion(dev, model, splat3_backward)
    paths = {"render_and_inversions": splat3_backward.launches}
    torch.cuda.empty_cache()

    encoder = phase_encoder(dev)
    phase_pnp(dev)
    hybrid = phase_hybrid(dev, model, encoder, splat3_backward)
    paths["hybrid_inversion"] = hybrid.pop("launches")
    summary["max_abs_err"] = max(summary["max_abs_err"], hybrid.pop("k1_max_abs_err"))
    summary["max_rel_err"] = max(summary["max_rel_err"], hybrid.pop("k1_max_rel_err"))
    torch.cuda.empty_cache()

    driver = phase_invert_driver(dev, model, encoder, splat3_backward)
    paths["invert_driver"] = driver.pop("launches")
    paths["invert_demo"] = driver.pop("demo_launches")
    summary["max_abs_err"] = max(summary["max_abs_err"], driver.pop("k1_max_abs_err"))
    summary["max_rel_err"] = max(summary["max_rel_err"], driver.pop("k1_max_rel_err"))
    del encoder
    torch.cuda.empty_cache()

    drive_root = os.path.join(REPO, "build", "invert_drive")
    driving = phase_driving(os.path.join(drive_root, "g_synthetic.pth"),
                            os.path.join(drive_root, "c_synthetic.pth"), splat3_backward)
    paths.update(driving.pop("launches"))
    summary["max_abs_err"] = max(summary["max_abs_err"], driving.pop("k1_max_abs_err"))
    summary["max_rel_err"] = max(summary["max_rel_err"], driving.pop("k1_max_rel_err"))
    torch.cuda.empty_cache()

    training = phase_train(dev, splat3_backward)
    paths.update(training.pop("launches"))
    summary["max_abs_err"] = max(summary["max_abs_err"], training.pop("k1_max_abs_err"))
    summary["max_rel_err"] = max(summary["max_rel_err"], training.pop("k1_max_rel_err"))
    encoder_training = phase_train_encoder(
        os.path.join(drive_root, "g_synthetic.pth"), splat3_backward)
    paths.update(encoder_training.pop("launches"))
    fid_eval = phase_fid(dev, os.path.join(drive_root, "g_synthetic.pth"), splat3_backward)
    paths.update(fid_eval.pop("launches"))
    summary["launches"] = sum(paths.values())
    summary["launches_by_path"] = paths
    summary["hybrid_inversion"] = hybrid
    summary["invert_driver"] = driver
    summary["driving"] = driving
    summary["train"] = training
    summary["train_encoder"] = encoder_training["timing"]
    summary["fid_eval"] = fid_eval["timing"]
    torch.cuda.empty_cache()

    probes = phase_probes(dev)

    print(json.dumps({"kernels": [summary] + probes}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
