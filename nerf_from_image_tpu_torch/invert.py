"""Hybrid inversion driver: `python -m nerf_from_image_tpu_torch.invert`.

Counterpart of invert.py, the JAX package's driver (the reference's
--run_inversion path), with the same command-line flags plus `--device`:
it loads a reference `.pth` generator (and optionally the bootstrap
encoder), takes each batch of the evaluation split, makes the first
guess of (w, pose) with `first_guess` (encoder, batched PnP), refines it
by Adam steps through the render (engine/inversion.py), scores steps 0
and n (engine/evaluate.py), and writes the report under
<root_path>/reports/inv_<dataset>/ (resumable from report_checkpoint.npz)
or, with --inv_export_demo_sample, one demo composite under outputs/.
When NFI_INCEPTION_WEIGHTS names pytorch-fid's Inception weights (and the
run is not a demo export), the evaluations also take the renders'
Inception activations, and the report's summary gives fid_front and
fid_random against the train-eval split's real statistics.
--inv_train_coord_only hands the command line to the encoder distillation
driver (train_encoder.py) instead.

Example (random weights, on the CPU):
  python -m nerf_from_image_tpu_torch.invert --dataset synthetic \\
      --batch_size 4 --resolution 32 --inv_steps 5 --max_images 8 \\
      --device cpu

Not ported yet, and refused with an error naming their ROADMAP.md item:
orbax checkpoints (a --resume_from or --coord_resume_from that is not a
.pth file) and more than one device (--chips, --gpus, --multihost).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.engine.inversion import (
    InversionConfig,
    PoseParams,
    build_camera,
    pose_params_from_matrix,
)
from nerf_from_image_tpu_torch.pose.pnp import estimate_poses_batch
from nerf_from_image_tpu_torch.utils.device import (
    check_on_device,
    resolve_device,
    set_strict_f32,
)


@torch.no_grad()
def first_guess(
    encoder,
    target_img: torch.Tensor,
    z_avg: torch.Tensor,
    config: InversionConfig,
    focal_guesses: Optional[np.ndarray] = None,
    pose: Optional[torch.Tensor] = None,
    focal: Optional[torch.Tensor] = None,
    no_split: bool = False,
    device="cuda",
) -> Tuple[torch.Tensor, PoseParams]:
    """The starting point of the inversion: (z0 [B, num_ws or 1, w_dim],
    pose params).

    target_img: [B, H, W, 3 or more] in [-1, 1]. z_avg: the generator's
    average w [1, num_ws, w_dim]. With `encoder` (models/encoder.py's
    BootstrapEncoder) z0 is its w broadcast to every layer, and the pose
    comes from PnP on its coordinate map with `focal_guesses`
    (pose/pnp.py::get_focal_guesses of the train focals; None for
    orthographic datasets). A head the encoder lacks, or encoder=None,
    leaves z0 at z_avg and the pose at (`pose`, `focal`). z0 is divided by
    config.lr_gain_z, as make_invert_fn takes it; `no_split` averages it
    over the layers (one w optimized for all). Tensors must lie on
    `device` ('cuda' by default, which needs a card).
    """
    dev = resolve_device(device)
    check_on_device(dev, target_img=target_img, z_avg=z_avg, pose=pose, focal=focal)
    bs = target_img.shape[0]
    w = z_avg
    if encoder is not None:
        coords, mask, w_pred = encoder(target_img[..., :3])
        if coords is not None:
            pose, est_focal, _ = estimate_poses_batch(coords, mask, focal_guesses)
            if est_focal is not None:
                focal = est_focal
        if w_pred is not None:
            w = w_pred
    if pose is None:
        raise ValueError("no pose: pass one, or an encoder with a pose head")
    z0 = w.expand((bs,) + tuple(z_avg.shape[1:])) / config.lr_gain_z
    if no_split:
        z0 = torch.mean(z0, dim=1, keepdim=True)
    return z0, pose_params_from_matrix(pose, focal, config.camera_flipped)


def refuse_multi_device(args) -> None:
    """Raises for --chips/--gpus > 1 and --multihost: the drivers run on
    one device."""
    if args.chips > 1 or args.multihost:
        raise NotImplementedError(
            "the port drives one device; more (--chips/--gpus > 1, --multihost) "
            "come with ROADMAP.md section 1 item 8 (scale and persistence)")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> Dict[str, object]:
    """Runs the inversion driver on the command line `argv` (sys.argv[1:]
    when None). Returns the run's timings: {'images': images inverted,
    'seconds': wall time of the batch loop, 'parts_ms': {'first_guess',
    'eval', 'refine': per-batch host times up to a device synchronize},
    'report_dir': where the report went}."""
    from nerf_from_image_tpu_torch import arguments
    from nerf_from_image_tpu_torch.data.loaders import (
        autodetect_dataset,
        get_coco_mapping,
        get_train_overrides,
        load_dataset,
        load_manual_image,
    )
    from nerf_from_image_tpu_torch.data.splits import (
        compute_eval_indices,
        compute_view_perm,
    )
    from nerf_from_image_tpu_torch.engine import evaluate as eval_mod
    from nerf_from_image_tpu_torch.engine import gan_eval
    from nerf_from_image_tpu_torch.engine.inversion import make_invert_fn
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.models.lpips import lpips_metric_grade, make_lpips
    from nerf_from_image_tpu_torch.pose.pnp import get_focal_guesses
    from nerf_from_image_tpu_torch.utils import fileio, tb
    from nerf_from_image_tpu_torch.utils.images import (
        coords_panel,
        normals_panel,
        save_image_grid,
    )
    from nerf_from_image_tpu_torch.utils.weights import (
        load_reference_encoder,
        load_reference_generator,
    )

    args = arguments.parse_args(argv)
    if args.inv_train_coord_only:
        # Train the bootstrap encoder and exit; encoder training has its own
        # driver.
        from nerf_from_image_tpu_torch import train_encoder

        return train_encoder.main(argv)
    refuse_multi_device(args)
    dev = resolve_device(args.device)
    set_strict_f32()  # the reference pins f32
    if args.dataset == "autodetect":
        # Dataset from the checkpoint/experiment name (reference:
        # run.py:62-64).
        if not args.resume_from:
            raise ValueError("--dataset or --resume_from required")
        args.dataset = autodetect_dataset(args.resume_from)
        print("Autodetected dataset:", args.dataset)
    overrides = get_train_overrides(args.dataset)
    # The generator takes the training driver's per-dataset presets: CARLA
    # checkpoints carry the view-direction branch.
    args.use_viewdir = args.use_viewdir or overrides.use_viewdir

    config_ds, train_split, train_eval_split, test_split = load_dataset(
        args.dataset,
        args.data_path,
        resolution=args.resolution,
        augment_p=0.0,
        need_test=args.inv_use_testset or overrides.inv_use_testset,
        max_images=args.max_images,
        imagenet_testset=args.inv_use_imagenet_testset,
    )
    target_split = test_split if test_split is not None else train_eval_split

    model = Generator(
        latent_dim=args.latent_dim,
        scene_range=config_ds.scene_range,
        attention_values=args.attention_values,
        use_viewdir=args.use_viewdir,
        use_sdf=args.use_sdf,
        device=dev,
        generator=torch.Generator().manual_seed(0),
    )
    if args.resume_from:
        load_reference_generator(model, args.resume_from)
        print("Loaded reference checkpoint", args.resume_from)
    model.requires_grad_(False)
    lpips = make_lpips(torch.Generator().manual_seed(1), device=dev)

    # Bootstrap encoder: latent + pose first guess (reference:
    # run.py:1961-1984).
    encoder = None
    if args.coord_resume_from:
        encoder = BootstrapEncoder(latent_dim=model.w_dim,
                                   separate_backbones=args.inv_use_separate, device=dev)
        load_reference_encoder(encoder, args.coord_resume_from)
        encoder.requires_grad_(False)
        print("Loaded encoder from", args.coord_resume_from)
    focal_guesses = get_focal_guesses(train_split.focal_length)

    # FID over the inversion outputs, with pytorch-fid's Inception weights
    # from NFI_INCEPTION_WEIGHTS; a demo export takes none.
    inception = None
    inception_weights = None if args.inv_export_demo_sample else gan_eval.inception_weights_path()
    if inception_weights:
        inception = gan_eval.load_fid_inception(inception_weights, dev)
        print("FID enabled (inception weights:", inception_weights + ")")

    n_steps = args.inv_steps or (10 if args.inv_gain_z >= 10 else 30)
    if args.inv_encoder_only:
        # Encoder-only evaluation: no optimization (reference:
        # run.py:1823-1825).
        n_steps = 0
    checkpoint_steps = [0, n_steps] if n_steps > 0 else [0]

    inv_config = InversionConfig(
        steps=n_steps,
        lr_gain_z=args.inv_gain_z,
        loss=args.inv_loss,
        optimize_pose=not (args.inv_no_optimize_pose or overrides.inv_no_optimize_pose),
        camera_flipped=config_ds.camera_flipped,
        white_background=config_ds.white_background,
    )
    # Without fine sampling the reference renders 128 samples a ray, and
    # its optimization loop 4 times as many (run.py:511-514, 2271); eval
    # renders stay at 128 (run.py:576).
    render_config = RenderConfig(
        resolution=args.resolution,
        depth_samples_per_ray=64 if args.fine_sampling else 512,
        fine_sampling=args.fine_sampling,
        scene_range=config_ds.scene_range,
        white_background=config_ds.white_background,
        use_viewdir=args.use_viewdir,
        query_chunk=args.query_chunk or None,
        plane_dtype=None if args.plane_dtype == "float32" else args.plane_dtype,
        plane_splat=args.plane_splat,
        merge_mode=args.merge_mode,
    )
    invert = make_invert_fn(inv_config, render_config, model, lpips=lpips, device=dev)
    eval_render_config = (
        render_config if args.fine_sampling
        else dataclasses.replace(render_config, depth_samples_per_ray=128)
    )
    eval_fn = eval_mod.make_eval_fn(inv_config, eval_render_config, model, lpips,
                                    inception_model=inception, has_mask=config_ds.has_mask,
                                    device=dev)

    # Average w init (reference: run.py:1852-1853).
    z_avg = model.average_w(generator=torch.Generator(device=dev).manual_seed(2))

    eval_indices = compute_eval_indices(target_split)
    eval_perm = compute_view_perm(
        eval_indices, config_ds.views_per_object_test or config_ds.views_per_object)
    if args.max_num_samples:
        eval_indices = eval_indices[: args.max_num_samples]
        eval_perm = eval_perm[: len(eval_indices)]

    demo_mode = args.inv_export_demo_sample
    if args.inv_manual_input_path:
        # Demo inference on a user's image: masked, cropped and spliced in
        # as sample 0 (reference: run.py:68-74, data/loaders.py:228-237).
        manual = load_manual_image(args.inv_manual_input_path, args.resolution,
                                   get_coco_mapping().get(args.dataset))
        target_split.images = np.array(target_split.images)
        nc = target_split.images.shape[-1]  # mask-less splits hold RGB only
        target_split.images[0] = manual["img"][..., :nc]
        if target_split.bbox is not None:
            target_split.bbox = np.array(target_split.bbox)
            target_split.bbox[0] = manual["normalized_bbox"]
        eval_indices = np.asarray([0])
        eval_perm = eval_perm[:1]
    elif demo_mode:
        # Randomized demo sample order (reference: run.py:1817-1821).
        shuffle_idx = np.random.RandomState(1).permutation(len(eval_indices))
        eval_indices = eval_indices[shuffle_idx]
        eval_perm = eval_perm[shuffle_idx]

    split_tag = "_imagenettest" if args.inv_use_imagenet_testset else ""
    report_dir = os.path.join(args.root_path, "reports", f"inv_{args.dataset}{split_tag}")
    report_ckpt_prefix = os.path.join(report_dir, "report_checkpoint")
    metric_notes = ({} if lpips_metric_grade()
                    else {"lpips": "(RANDOM-FEATURE — not metric grade)"})
    report = eval_mod.InversionReport(checkpoint_steps, metric_notes)
    resume_idx = 0
    if not demo_mode and fileio.file_exists(report_ckpt_prefix + ".npz"):
        # Resumable reports (reference: run.py:1858-1871, 2329-2336); notes
        # merge so that no row's provenance is upgraded.
        report = eval_mod.InversionReport.load(report_ckpt_prefix)
        report.merge_notes_on_resume(metric_notes)
        resume_idx = report.num_samples()
        print(f"Resuming inversion report at image {resume_idx}")
    # The reference's inversion batch on one device: batch_size // 4
    # (run.py:1757).
    bs = max(1, args.batch_size // 4)
    generator = torch.Generator(device=dev).manual_seed(3)

    # Renders for the demo composite and TB grids: front and novel views
    # with normal maps (reference: run.py:2040-2159).
    demo_config = dataclasses.replace(eval_render_config, compute_normals=bool(args.use_sdf))

    @torch.no_grad()
    def demo_render(z, cam, focal, center=None, bbox=None):
        out, _ = render(demo_config, model, cam, focal, z * inv_config.lr_gain_z,
                        center=center, bbox=bbox, force_no_cam_grad=True, device=dev)
        return out

    def host(t):
        return t.detach().cpu().numpy()

    def to_dev(x):
        if x is None:
            return None
        x = np.asarray(x)
        return torch.as_tensor(x, dtype=torch.float32 if x.dtype.kind == "f" else None,
                               device=dev)

    # TensorBoard sink (reference: run.py:1779-1783, 2104-2131); a no-op
    # without tensorboardX.
    writer = tb.Logger(os.path.join(report_dir, "tb"))
    parts_ms = {"first_guess": [], "eval": [], "refine": []}
    images_done = 0
    t0 = time.time()

    for start in range(resume_idx, len(eval_indices), bs):
        idx = eval_indices[start : start + bs]
        n_real = len(idx)
        if n_real < bs:
            # Ragged tail: padded by repeating the last index; the padded
            # rows are dropped from every metric.
            idx = np.concatenate([idx, np.repeat(idx[-1:], bs - n_real)])
        idx_perm = eval_perm[start : start + bs]
        if len(idx_perm) < bs:
            idx_perm = np.concatenate(
                [idx_perm, np.repeat(idx_perm[-1:], bs - len(idx_perm))])
        sel = target_split.select(idx)
        # Novel-view (perm) split: p3d on the test set draws perm poses from
        # the training pose distribution (reference: run.py:1895-1906).
        perm_split = (
            train_eval_split
            if (test_split is not None and "p3d" in args.dataset
                and train_eval_split is not None)
            else target_split
        )
        sel_perm = perm_split.select(idx_perm)
        # Optimization target (reference: run.py:1920-1944): on the train
        # split outside demo mode, the uncropped train image (full-patch
        # render), while the metrics compare the cropped train-eval view
        # rendered through its center and bbox. Demo mode and the test set
        # optimize against the eval image itself.
        if test_split is None and not demo_mode:
            target_img = to_dev(train_split.select(idx).images)
            front_center = to_dev(sel.center)
            front_bbox = to_dev(sel.bbox)
        else:
            target_img = to_dev(sel.images)
            front_center = front_bbox = None
        target_img_fid = to_dev(sel.images)
        pose_gt = to_dev(sel.tform_cam2world)
        focal_gt = to_dev(sel.focal_length)
        perm_pose = to_dev(sel_perm.tform_cam2world)
        perm_focal = to_dev(sel_perm.focal_length)
        # Novel-view metrics exist only with several registered views per
        # object (reference: run.py:2160).
        views_per_object = (config_ds.views_per_object_test if test_split is not None
                            else config_ds.views_per_object)
        perm_imgs = to_dev(sel_perm.images) if (views_per_object or 1) > 1 else None
        perm_center = to_dev(sel_perm.center)
        perm_bbox = to_dev(sel_perm.bbox)

        def take_real(tree):
            """Drops the padded tail rows before accumulation."""
            return {k: host(v)[:n_real] for k, v in tree.items() if v is not None}

        def recovered(z, p):
            return take_real({"ws": z * inv_config.lr_gain_z, "R": p.q, "s": p.s,
                              "t2": p.t2})

        t_part = time.perf_counter()

        def part(name):
            nonlocal t_part
            _sync(dev)
            now = time.perf_counter()
            parts_ms[name].append((now - t_part) * 1e3)
            t_part = now

        # Init: the encoder's w and the PnP pose when the encoder is
        # loaded; the average w and the ground-truth pose otherwise.
        z0, pose0 = first_guess(encoder, target_img, z_avg, inv_config, focal_guesses,
                                pose=pose_gt, focal=focal_gt, no_split=args.inv_no_split,
                                device=dev)
        part("first_guess")
        metrics0 = eval_fn(z0, pose0, target_img_fid, pose_gt, perm_pose, perm_focal,
                           perm_imgs, center=front_center, bbox=front_bbox,
                           perm_center=perm_center, perm_bbox=perm_bbox)
        report.add(0, take_real(metrics0), recovered(z0, pose0))
        part("eval")

        first_batch = start == resume_idx
        if first_batch:
            # First-batch image grids at step 0 (reference: run.py:2104-2110).
            writer.images("img/ref", host(target_img_fid[..., :3]), 0)
            out0 = demo_render(z0, *build_camera(pose0, config_ds.camera_flipped))
            writer.images("img/recon_front", host(torch.clamp(out0.rgb[..., :3], -1, 1)), 0)
            del out0
            t_part = time.perf_counter()

        z_f, pose_f = z0, pose0
        if n_steps > 0:
            z_f, pose_f, losses = invert(z0, pose0, target_img, generator=generator,
                                         n_steps=n_steps)
            part("refine")
            metrics_n = eval_fn(z_f, pose_f, target_img_fid, pose_gt, perm_pose,
                                perm_focal, perm_imgs, center=front_center, bbox=front_bbox,
                                perm_center=perm_center, perm_bbox=perm_bbox)
            report.add(n_steps, take_real(metrics_n), recovered(z_f, pose_f))
            part("eval")
            if first_batch:
                # Loss curve and final grids (reference: run.py:2104-2131).
                for t, lv in enumerate(host(losses).reshape(-1)):
                    writer.scalar("loss/inversion", float(lv), t)
                out_fv = demo_render(z_f, *build_camera(pose_f, config_ds.camera_flipped))
                writer.images("img/recon_front",
                              host(torch.clamp(out_fv.rgb[..., :3], -1, 1)), n_steps)
                writer.images("img/mask_front",
                              host(torch.clamp(out_fv.mask, 0, 1))[..., None], n_steps)
                if out_fv.normals is not None:
                    writer.images("img/normals_front",
                                  host(torch.clamp(out_fv.normals, -1, 1)), n_steps)
                writer.flush()
                del out_fv
        if demo_mode:
            # Side-by-side composite at the last step, first batch only
            # (reference: run.py:2058-2159, 2325-2327); the novel view goes
            # through the perm view's crop (run.py:2126-2130).
            out_f = demo_render(z_f, *build_camera(pose_f, config_ds.camera_flipped))
            out_n = demo_render(z_f, perm_pose, perm_focal, perm_center, perm_bbox)
            coords = mask_pred = None
            if encoder is not None:
                with torch.no_grad():
                    coords, mask_pred, _ = encoder(target_img[..., :3])
            rows = []
            for b in range(n_real):
                panels = [host(target_img[b, ..., :3])]
                if coords is not None:
                    panels.append(coords_panel(host(coords[b]), host(mask_pred[b]),
                                               config_ds.scene_range,
                                               config_ds.white_background))
                panels.append(host(torch.clamp(out_f.rgb[b, ..., :3], -1, 1)))
                if out_f.normals is not None:
                    panels.append(normals_panel(host(out_f.normals[b]), host(out_f.mask[b])))
                panels.append(host(torch.clamp(out_n.rgb[b, ..., :3], -1, 1)))
                if out_n.normals is not None:
                    panels.append(normals_panel(host(out_n.normals[b]), host(out_n.mask[b])))
                rows.append(panels)
            out_fname = (f"demo_manual_{args.dataset}_{n_steps}it.png"
                         if args.inv_manual_input_path
                         else f"sample_{args.dataset}_{n_steps}it.png")
            save_image_grid(rows, os.path.join("outputs", out_fname))
            images_done += n_real
            break

        done = start + n_real
        images_done += n_real
        print(f"[{done}/{len(eval_indices)}] "
              f"{(time.time() - t0) / max(done - resume_idx, 1):.3f} s/img")
        if done % 512 < bs and done < len(eval_indices):
            # Resumable report checkpoint every ~512 images (reference:
            # run.py:2329-2336).
            report.save(report_ckpt_prefix)

    stats = {"images": images_done, "seconds": time.time() - t0, "parts_ms": parts_ms,
             "report_dir": report_dir}
    if demo_mode:
        # No consolidated report in demo mode (reference: run.py:2338).
        return stats
    # The real images' statistics for the front and random FIDs.
    fid_stats_real = None
    if inception is not None:
        fid_stats_real = gan_eval.compute_real_fid_stats(
            inception, train_eval_split.images[..., :3], device=dev)
    print(report.save(os.path.join(report_dir, "report"), fid_stats_real))
    print("Report written to", report_dir)
    return stats


if __name__ == "__main__":
    main()
