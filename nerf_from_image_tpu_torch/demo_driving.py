"""Single-frame driving demo: `python -m nerf_from_image_tpu_torch.demo_driving`.

Counterpart of demo_driving.py, the JAX package's demo (the reference's
demo_nusc.py:666-700), with the same command-line flags plus `--device`:
given a nuScenes camera frame by file name (`--inv_manual_input_path`), it
loads the frame's Mask-RCNN instances, crops each detected car, makes the
first guess (the bootstrap encoder's w, the pose from known-intrinsics PnP)
and inverts it, and saves one row per car (input | NOCS coords |
reconstruction | depth | normals | novel view, demo_nusc.py:518-540 plus
the random-rotation view of eval_kitti_persp.py:631-668) to
outputs/demo_<dataset>_<frame>.png.

Example (random weights, on the CPU, a synthetic tree from
data/driving_fixtures.py):
  python -m nerf_from_image_tpu_torch.demo_driving --dataset nusc \\
      --nusc_data_dir <tree> --inv_manual_input_path <frame>.png \\
      --resolution 32 --inv_steps 2 --device cpu

Refused with an error naming ROADMAP.md section 1 item 8: orbax
checkpoints and more than one device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict

import numpy as np
import torch

from nerf_from_image_tpu_torch.utils.images import (
    coords_panel,
    depth_panel,
    normals_panel,
    save_image_grid,
)


def main(argv=None) -> Dict[str, object]:
    """Runs the demo on the command line `argv` (sys.argv[1:] when None).
    Returns {'cars': cars inverted, 'seconds': wall time of the car loop,
    'parts_ms': {'first_guess', 'refine', 'render': per car, host times up
    to a device synchronize}, 'steps', 'output': the PNG's path}."""
    from scipy.spatial.transform import Rotation

    from nerf_from_image_tpu_torch import arguments
    from nerf_from_image_tpu_torch.data.configs import get_dataset_config
    from nerf_from_image_tpu_torch.data.driving import (
        crop_for_inversion,
        get_mask_occ_from_ins,
        load_instance_masks,
    )
    from nerf_from_image_tpu_torch.data.nusc_lite import NuScenesLite
    from nerf_from_image_tpu_torch.engine.inversion import (
        InversionConfig,
        build_camera,
        make_invert_fn,
        pose_params_from_matrix,
    )
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.invert import refuse_multi_device
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.models.lpips import make_lpips
    from nerf_from_image_tpu_torch.pose import pnp
    from nerf_from_image_tpu_torch.pose.pose import invert_space
    from nerf_from_image_tpu_torch.utils.device import resolve_device, set_strict_f32
    from nerf_from_image_tpu_torch.utils.images import read_image
    from nerf_from_image_tpu_torch.utils.weights import (
        load_reference_encoder,
        load_reference_generator,
    )

    args = arguments.parse_args(argv)
    refuse_multi_device(args)
    dev = resolve_device(args.device)
    set_strict_f32()  # the reference pins f32
    # The reference demo overrides the driving eval config with the
    # generator's native frame: scene_range 1.4, grey background
    # (demo_nusc.py:34, unlike eval_nusc_persp's 3.0/white), so crops feed
    # the p3d-trained encoder directly and no coordinate rescale applies.
    config_ds = dataclasses.replace(get_dataset_config(args.dataset), scene_range=1.4,
                                    white_background=False)
    flipped = config_ds.camera_flipped

    # The frame and its instances, through the lite nuScenes reader.
    nusc = NuScenesLite(args.nusc_version, args.nusc_data_dir)
    filename = os.path.basename(args.inv_manual_input_path or "")
    cam_data = next((sd for sd in nusc.sample_data if "CAM" in sd.get("channel", "")
                     and os.path.basename(sd["filename"]) == filename), None)
    if cam_data is None:
        raise FileNotFoundError(f"frame {filename} not found")
    data_path, _, K = nusc.get_sample_data(cam_data["token"])
    img_org = read_image(data_path)[..., :3]
    seg_dir = os.path.join(args.nusc_data_dir, "pred_instance", cam_data["channel"])
    stem = os.path.basename(data_path)[:-4]
    preds, ins_masks = load_instance_masks(seg_dir, stem)

    def is_car(i):
        # Two Mask-RCNN dump schemas: the reference's string labels
        # ('car' in preds['labels'][ii], demo_nusc.py:680 /
        # datasets.py:1003) and COCO integer ids ('classes', id 2 = car).
        if "labels" in preds:
            return "car" in str(preds["labels"][i])
        return int(preds["classes"][i]) == 2

    crops = [crop_for_inversion(img_org, get_mask_occ_from_ins(ins_masks, i), None,
                                preds["boxes"][i], K, args.resolution,
                                white_bkgd=config_ds.white_background)
             for i in range(len(ins_masks)) if is_car(i)]
    if not crops:
        raise ValueError(f"no cars detected in frame {filename}")
    print(f"Inverting {len(crops)} cars")

    model = Generator(latent_dim=args.latent_dim, scene_range=config_ds.scene_range,
                      attention_values=args.attention_values, use_sdf=args.use_sdf,
                      device=dev, generator=torch.Generator().manual_seed(0))
    if args.resume_from:
        load_reference_generator(model, args.resume_from)
        print("Loaded generator from", args.resume_from)
    model.requires_grad_(False)
    encoder = None
    if args.coord_resume_from:
        encoder = BootstrapEncoder(latent_dim=model.w_dim,
                                   separate_backbones=args.inv_use_separate, device=dev)
        load_reference_encoder(encoder, args.coord_resume_from)
        encoder.requires_grad_(False)
    lpips = make_lpips(torch.Generator().manual_seed(2), device=dev)

    steps = args.inv_steps or 30
    inv_config = InversionConfig(steps=steps, lr_gain_z=args.inv_gain_z, loss=args.inv_loss,
                                 camera_flipped=flipped,
                                 white_background=config_ds.white_background)
    render_config = RenderConfig(
        resolution=args.resolution, depth_samples_per_ray=64, fine_sampling=True,
        scene_range=config_ds.scene_range, white_background=config_ds.white_background,
        query_chunk=args.query_chunk or None,
        plane_dtype=None if args.plane_dtype == "float32" else args.plane_dtype,
        plane_splat=args.plane_splat, merge_mode=args.merge_mode,
    )
    # Demo panels render with SDF normals like the reference
    # (demo_nusc.py:502 compute_normals=args.use_sdf).
    demo_config = dataclasses.replace(render_config, compute_normals=bool(args.use_sdf))
    invert = make_invert_fn(inv_config, render_config, model, lpips=lpips, device=dev)
    z_avg = model.average_w(generator=torch.Generator(device=dev).manual_seed(3))

    @torch.no_grad()
    def demo_render(cam, focal, z):
        # Full-patch render, no principal-point offset: the reference demo
        # uses target_center=None throughout (demo_nusc.py:951).
        out, _ = render(demo_config, model, cam, focal, z * inv_config.lr_gain_z,
                        force_no_cam_grad=True, device=dev)
        return out

    def host(t):
        return t.detach().cpu().numpy()

    parts_ms = {"first_guess": [], "refine": [], "render": []}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        parts_ms[name].append((now - t_part) * 1e3)
        t_part = now

    rows = []
    np_rng = np.random.default_rng(543)
    t0 = time.time()
    for i, sample in enumerate(crops):
        t_part = time.perf_counter()
        target = torch.as_tensor(sample["img"], device=dev)[None]
        Kc = sample["K"]
        focal = torch.as_tensor(Kc[0:1, 0], device=dev)
        if encoder is not None:
            with torch.no_grad():
                coords, mask_pred, w_pred = encoder(target[..., :3])
            coords = coords * (config_ds.scene_range / 1.4)
            w2c, _ = pnp.compute_pose_pnp_known_k(coords, mask_pred,
                                                  torch.as_tensor(Kc, device=dev)[None])
            init_pose = invert_space(w2c)
            # Regressed w [B, 1, w_dim] -> per-layer ws (w-space latent).
            z0 = w_pred.expand(1, model.num_ws, w_pred.shape[-1]) / inv_config.lr_gain_z
            coords_vis = coords_panel(host(coords)[0], host(mask_pred)[0],
                                      config_ds.scene_range, False)
        else:
            init_pose = torch.eye(4, device=dev)[None].clone()
            init_pose[:, 2, 3] = 3.0
            z0 = (z_avg / inv_config.lr_gain_z).expand((1,) + tuple(z_avg.shape[1:]))
            coords_vis = np.zeros_like(sample["img"])
        pose_params = pose_params_from_matrix(init_pose, focal, flipped)
        part("first_guess")
        z_f, pose_f, _ = invert(z0, pose_params, target,
                                generator=torch.Generator(device=dev).manual_seed(10 + i),
                                n_steps=steps)
        part("refine")
        cam_f, focal_f = build_camera(pose_f, flipped)
        out = demo_render(cam_f, focal_f, z_f)
        # Novel view: the recovered camera perturbed by a random rotation
        # (reference: eval_kitti_persp.py:631-645; demo_nusc.py:528-534).
        angle_lim = np.pi * 0.2
        rotvec = np_rng.uniform(-angle_lim, angle_lim, size=3)
        w2c_p = host(invert_space(cam_f))
        w2c_p[0, :3, :3] = w2c_p[0, :3, :3] @ Rotation.from_rotvec(
            rotvec).as_matrix().astype(np.float32)
        out_p = demo_render(invert_space(torch.as_tensor(w2c_p, device=dev)), focal_f, z_f)
        mask0 = host(out.mask)[0]
        depth_vis = depth_panel(host(out.depth)[0], mask0, config_ds.white_background)
        normals_vis = (normals_panel(host(out.normals)[0], mask0) if out.normals is not None
                       else np.zeros_like(depth_vis))
        rows.append([sample["img"][..., :3], coords_vis,
                     host(torch.clamp(out.rgb[0, ..., :3], -1, 1)), depth_vis, normals_vis,
                     host(torch.clamp(out_p.rgb[0, ..., :3], -1, 1))])
        part("render")

    out_path = os.path.join("outputs", f"demo_{args.dataset}_{stem}.png")
    save_image_grid(rows, out_path)
    return {"cars": len(crops), "seconds": time.time() - t0, "parts_ms": parts_ms,
            "steps": steps, "output": out_path}


if __name__ == "__main__":
    main()
