"""Driving vehicle-inversion evaluation: `python -m nerf_from_image_tpu_torch.eval_driving`.

Counterpart of eval_driving.py, the JAX package's driver (the reference's
eval_nusc_persp.py / eval_kitti_persp.py / eval_waymo_persp.py), with the
same command-line flags plus `--device`: for each annotated vehicle of a
nuScenes, KITTI or Waymo evaluation subset it makes a first guess (the
bootstrap encoder's w, and the pose from known-intrinsics PnP on its
coordinate map, or the ground-truth or external SUP-NeRF pose), refines
(w, R, s, t) -- never the focal -- by Adam steps through the render, and
reports masked PSNR, SSIM, LPIPS, the LiDAR z-buffer depth error and the
rotation and translation errors at checkpoints {0, 20, 50}, plus novel-view
columns: on nuScenes against another annotation of the same instance, on
KITTI and Waymo a random rotation of the fitted camera, whose depth error
is scored against the LiDAR depth reprojected into it (`reproject_depth`)
and whose image metrics are NaN (no image exists there).

Example (random weights, on the CPU, a synthetic tree from
data/driving_fixtures.py):
  python -m nerf_from_image_tpu_torch.eval_driving --dataset nusc \\
      --nusc_data_dir <tree> --driving_index_file <tree>/v1.0-mini/index.json \\
      --resolution 32 --inv_steps 2 --device cpu

Refused with an error naming ROADMAP.md section 1 item 8: orbax
checkpoints (a --resume_from or --coord_resume_from that is not a .pth
file) and more than one device (--chips, --gpus, --multihost).
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict

import numpy as np
import torch

from nerf_from_image_tpu_torch.data.driving import NUSC2SHAPENET
from nerf_from_image_tpu_torch.utils.images import coords_panel, depth_panel

P3D_SCENE_RANGE = 1.4  # The encoder is trained on p3d_car.

# p3d_car training-set focal-length percentiles, used by the focal-search
# PnP init when true intrinsics are ignored (reference:
# eval_nusc_persp.py:39-40 / eval_nusc.py:39 record these manually because
# the driving evals run without the p3d training split on disk).
P3D_FOCAL_GUESSES = np.asarray([
    0.71839845, 1.07731938, 1.32769489, 1.59814608, 1.88348041,
    2.27928376, 2.82873106, 3.73867059, 5.14416647, 9.12456608,
    27.79907417,
])


def build_dataset(args):
    if args.dataset == "nusc":
        from nerf_from_image_tpu_torch.data.nusc_lite import NuScenesDrivingDataset

        return NuScenesDrivingDataset(
            args.nusc_data_dir, args.nusc_version, img_size=args.resolution,
            white_bkgd=True, external_pose_file=args.external_pose_file,
            index_file=args.driving_index_file or None,
        )
    from nerf_from_image_tpu_torch.data.driving import KittiDrivingDataset

    if args.dataset == "kitti":
        return KittiDrivingDataset(args.kitti_data_dir, img_size=args.resolution,
                                   white_bkgd=True)
    if args.dataset == "waymo":
        return KittiDrivingDataset(args.waymo_data_dir, img_size=args.resolution,
                                   white_bkgd=True, split="validation", is_waymo=True)
    raise ValueError(f"the driving evaluation takes nusc, kitti or waymo, not {args.dataset!r}")


def cam_pose_to_render_frame(cam_pose_34, camera_flipped=True):
    """[3, 4] camera-in-object pose -> render-frame cam2world (reference:
    eval_nusc_persp.py:1129-1139: nusc2shapenet remap + y/z flip)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :] = cam_pose_34
    m = NUSC2SHAPENET @ m
    if camera_flipped:
        m[:3, 1:3] *= -1
    return m


def export_driving_demo(args, config_ds, obj_idx, it, sample, coords, mask_pred, metrics,
                        out, out_p, perm_target=None):
    """Saves the per-object demo composite (reference:
    eval_nusc_persp.py:553-802): input | NOCS coords | recon | depth |
    [cross-view GT] | cross-view recon | cross depth. Arrays are numpy
    (renders as CompositeOutput of numpy arrays)."""
    from nerf_from_image_tpu_torch.utils.images import save_image_grid

    panels = [np.asarray(sample["img"])[..., :3]]
    if coords is not None:
        panels.append(coords_panel(np.asarray(coords)[0], np.asarray(mask_pred)[0],
                                   config_ds.scene_range, config_ds.white_background))
    panels.append(np.clip(out.rgb[0, ..., :3], -1, 1))
    panels.append(depth_panel(out.depth[0], out.mask[0], config_ds.white_background))
    if out_p is not None:
        if perm_target is not None:
            # The reference shows the cross-view ground truth beside the
            # novel-view recon (eval_nusc_persp.py:763-765).
            panels.append(np.asarray(perm_target)[0, ..., :3])
        panels.append(np.clip(out_p.rgb[0, ..., :3], -1, 1))
        panels.append(depth_panel(out_p.depth[0], out_p.mask[0], config_ds.white_background))
    row = np.concatenate(panels, axis=1)

    eval_str = "PSNR: {:.2f},  Depth Err: {:.2f}, R Err: {:.2f}, T Err: {:.2f}".format(
        float(np.mean(metrics["psnr"])), float(np.mean(metrics["depth_error"])),
        float(np.mean(metrics["rot_error"])), float(np.mean(metrics["trans_error"])))
    if "psnr_random" in metrics:
        eval_str += ", PSNR-C: {:.2f}, Depth Err-C: {:.2f}".format(
            float(np.mean(metrics["psnr_random"])),
            float(np.mean(metrics["depth_error_random"])))
    try:
        import cv2

        img8 = ((row / 2 + 0.5) * 255).clip(0, 255).astype(np.uint8)
        img8 = cv2.putText(img8.copy(), eval_str, (260, 10), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                           (0, 0, 0))
        row = img8.astype(np.float32) / 255 * 2 - 1
    except ImportError:
        print(eval_str)

    out_dir = os.path.join("outputs", f"eval_{args.dataset}")
    save_image_grid([[row]], os.path.join(out_dir, f"demo_obj{obj_idx}_{it}it.png"))


def reproject_depth(depth: np.ndarray, K: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Reprojects a sparse z-buffer depth map into a perturbed camera.

    depth: [S, S] z-buffer depths (>0 valid) at the original crop view.
    K: normalized crop intrinsics -- f = K[0,0], principal point K[:2,2]
      relative to the crop center (data/driving.py crop_for_inversion).
    M: [4, 4] original-camera -> perturbed-camera transform in the RENDER
      camera frame (w2c_perm @ c2w_orig; camera looks down -z, X right,
      Y up -- ops/rays.py get_ray_bundle).

    Returns the [S, S] sparse z-buffer depth at the perturbed view (0
    where no LiDAR point lands); nearer points win contended pixels. Only
    contention between points is resolved: a point that the object hides
    at the new view still counts (rare for the visible surface of one
    vehicle; the JAX package's docstring discusses the bias).
    """
    S = depth.shape[0]
    r, c = np.nonzero(depth > 0)
    out = np.zeros_like(depth)
    if r.size == 0:
        return out
    d = depth[r, c].astype(np.float64)
    f = float(K[0, 0])
    cx = float(K[0, 2]) + 0.5
    cy = float(K[1, 2]) + 0.5
    # Inverse of the ray-grid projection ii = col/S - cx = f*X/(-Z),
    # jj = row/S - cy = f*(-Y)/(-Z), zbuffer = -Z.
    X = (c / S - cx) / f * d
    Y = -((r / S - cy) / f) * d
    Z = -d
    q = M @ np.stack([X, Y, Z, np.ones_like(d)], axis=0)
    zb = -q[2]
    keep = zb > 1e-6
    # Round to the nearest grid sample: the forward ray grid samples at
    # exactly col/S - cx, so a grid-aligned point's inverse is an integer.
    col = np.floor((f * q[0] / np.maximum(zb, 1e-6) + cx) * S + 0.5).astype(np.int64)
    row = np.floor((f * (-q[1]) / np.maximum(zb, 1e-6) + cy) * S + 0.5).astype(np.int64)
    keep &= (col >= 0) & (col < S) & (row >= 0) & (row < S)
    order = np.argsort(-zb[keep])
    out[row[keep][order], col[keep][order]] = zb[keep][order]
    return out


def random_rotation(rng: random.Random) -> np.ndarray:
    """A rotation by a rotation vector of three uniform draws in
    +-0.2 pi from `rng` (the novel views of eval_kitti_persp.py:631-645)."""
    from scipy.spatial.transform import Rotation  # imported by main() up front

    angle_lim = np.pi * 0.2
    rotvec = [rng.uniform(-angle_lim, angle_lim) for _ in range(3)]
    return Rotation.from_rotvec(rotvec).as_matrix()


def _host(out):
    """A CompositeOutput of tensors -> the same of numpy arrays."""
    return out._replace(**{k: v.detach().cpu().numpy() for k, v in out._asdict().items()
                           if isinstance(v, torch.Tensor)})


def main(argv=None) -> Dict[str, object]:
    """Runs the driving evaluation on the command line `argv` (sys.argv[1:]
    when None). Returns {'objects': objects inverted, 'seconds': wall time
    of the object loop, 'parts_ms': {'data': per object, 'first_guess':
    per object, 'eval': per checkpoint evaluation, 'refine': per
    refinement segment (host times up to a device synchronize)}, 'steps':
    the refinement steps an object takes, 'report_dir'}."""
    from nerf_from_image_tpu_torch import arguments
    from nerf_from_image_tpu_torch.data.configs import get_dataset_config
    from nerf_from_image_tpu_torch.engine import evaluate as eval_mod
    from nerf_from_image_tpu_torch.engine.inversion import (
        InversionConfig,
        build_camera,
        make_invert_fn,
        pose_params_from_matrix,
    )
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.invert import refuse_multi_device
    from nerf_from_image_tpu_torch.metrics import image as image_metrics
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.models.lpips import lpips_metric_grade, make_lpips
    from nerf_from_image_tpu_torch.pose import pnp
    from nerf_from_image_tpu_torch.pose.pose import invert_space, rotation_matrix_distance
    from nerf_from_image_tpu_torch.utils.device import resolve_device, set_strict_f32
    from nerf_from_image_tpu_torch.utils.weights import (
        load_reference_encoder,
        load_reference_generator,
    )
    from scipy.spatial.transform import Rotation  # noqa: F401 (random_rotation)

    args = arguments.parse_args(argv)
    refuse_multi_device(args)
    if args.dataset not in ("nusc", "kitti", "waymo"):
        raise ValueError(f"the driving evaluation takes nusc, kitti or waymo, not "
                         f"{args.dataset!r}")
    dev = resolve_device(args.device)
    set_strict_f32()  # the reference pins f32
    config_ds = get_dataset_config(args.dataset)
    flipped = config_ds.camera_flipped
    dataset = build_dataset(args)
    print(f"{len(dataset)} objects in {args.dataset} eval")

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
        print("Loaded encoder from", args.coord_resume_from)
    lpips = make_lpips(torch.Generator().manual_seed(2), device=dev)

    checkpoint_steps = [0, 20, 50]
    if args.inv_steps:
        checkpoint_steps = [0, args.inv_steps]
    niter = max(checkpoint_steps)
    inv_config = InversionConfig(
        steps=niter, lr_gain_z=args.inv_gain_z, loss=args.inv_loss,
        optimize_pose=not args.no_optimize_pose, optimize_focal=False,
        camera_flipped=flipped, white_background=config_ds.white_background,
    )
    render_config = RenderConfig(
        resolution=args.resolution, depth_samples_per_ray=64, fine_sampling=True,
        scene_range=config_ds.scene_range, white_background=config_ds.white_background,
        query_chunk=args.query_chunk or None,
        plane_dtype=None if args.plane_dtype == "float32" else args.plane_dtype,
        plane_splat=args.plane_splat, merge_mode=args.merge_mode, zbuffer_depth=True,
    )
    invert = make_invert_fn(inv_config, render_config, model, lpips=lpips, device=dev)

    @torch.no_grad()
    def render_for_eval(z, pose_params, center):
        cam, focal = build_camera(pose_params, flipped)
        out, _ = render(render_config, model, cam, focal, z * inv_config.lr_gain_z,
                        center=center, force_no_cam_grad=True, device=dev)
        return out, cam

    z_avg = model.average_w(generator=torch.Generator(device=dev).manual_seed(3))

    metric_notes = ({} if lpips_metric_grade()
                    else {"lpips": "(RANDOM-FEATURE — not metric grade)"})
    if args.dataset != "nusc":
        nv_note = ("(NaN by design: no cross-view GT image on kitti/waymo; "
                   "reference leaves these columns empty)")
        metric_notes.update({"psnr_random": nv_note, "ssim_random": nv_note,
                             "lpips_random": nv_note})
    report = eval_mod.InversionReport(checkpoint_steps, metric_notes)
    report_dir = os.path.join(args.root_path, "reports", f"eval_{args.dataset}")
    rng = random.Random(543)
    n_objects = min(len(dataset), args.max_num_samples or len(dataset))

    def to_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    parts_ms = {"data": [], "first_guess": [], "eval": [], "refine": []}
    t_part = time.perf_counter()

    def lap() -> float:
        """ms since the last lap, up to a device synchronize."""
        nonlocal t_part
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now, before = time.perf_counter(), t_part
        t_part = now
        return (now - before) * 1e3

    def part(name):
        parts_ms[name].append(lap())

    objects = 0
    t0 = time.time()
    for idx in range(n_objects):
        t_part = time.perf_counter()
        sample = dataset[idx]
        target_img = to_dev(sample["img"])[None]
        target_mask_input = to_dev(sample["mask"])[None]
        K = sample["K"]
        target_focal = to_dev([K[0, 0]])
        target_center = to_dev(K[None, :2, 2]) + 0.5
        gt_cam2world = to_dev(cam_pose_to_render_frame(sample["cam_pose"], flipped))[None]
        gt_depth = to_dev(sample["depth"])[None]
        gt_depth_mask = gt_depth > 0
        data_ms = lap()

        # Encoder first guess: grey-background input, p3d scene scale.
        enc_img = target_img[..., :3]
        if config_ds.white_background:
            enc_img = enc_img + (target_mask_input[..., None] - 1.0) * 0.5
        if encoder is not None:
            with torch.no_grad():
                coords, mask_pred, w_pred = encoder(enc_img)
            coords = coords * (config_ds.scene_range / P3D_SCENE_RANGE)
            z_ = w_pred
            if (args.init_pose_type not in ("gt", "external")
                    and float(torch.sum(mask_pred > 0.9)) == 0):
                # Reference skips objects whose predicted mask is empty
                # (eval_nusc_persp.py:341-344, 1160-1163).
                print("Empty mask detected, skipping...")
                continue
        else:
            coords = mask_pred = None
            z_ = z_avg[None] if z_avg.dim() == 2 else z_avg

        init_focal = target_focal
        if args.init_pose_type == "external" and "obj_pose_ext" in sample:
            # Externally estimated (SUP-NeRF) world2cam -> render-frame
            # cam2world (reference: eval_nusc_persp.py:1171-1180).
            ext_w2c = np.eye(4, dtype=np.float32)
            ext_w2c[:3, :] = sample["obj_pose_ext"]
            ext_c2w = invert_space(torch.from_numpy(ext_w2c)[None])[0].numpy()
            init_cam2world = to_dev(cam_pose_to_render_frame(ext_c2w[:3, :], flipped))[None]
        elif args.init_pose_type == "gt" or coords is None:
            init_cam2world = gt_cam2world
        elif args.init_pose_type == "pnp_focal_search":
            # Older-variant protocol (reference: eval_nusc.py): ignore the
            # true intrinsics and search the p3d focal percentiles.
            init_cam2world, init_focal, _ = pnp.estimate_poses_batch(
                coords, mask_pred, P3D_FOCAL_GUESSES)
        else:
            w2c, _ = pnp.compute_pose_pnp_known_k(coords, mask_pred, to_dev(K)[None])
            init_cam2world = invert_space(w2c)

        # Split per-layer ws by default; --inv_no_split collapses to one w
        # (reference: eval_nusc_persp.py:1143, 1196-1197).
        if z_.dim() == 2:
            z_ = z_[:, None, :]
        if z_.shape[1] == 1:
            z_ = z_.expand(z_.shape[0], model.num_ws, z_.shape[-1])
        if args.inv_no_split:
            z_ = torch.mean(z_, dim=1, keepdim=True)
        z_ = z_ / inv_config.lr_gain_z
        pose_params = pose_params_from_matrix(init_cam2world, init_focal, flipped)
        part("first_guess")

        # Cross-view target: another annotation of the same instance
        # (reference: eval_nusc_persp.py:662-692 — image, mask, LiDAR
        # depth and intrinsics all come from the other view).
        perm_pose_params = perm_img = perm_mask = perm_depth = perm_center = None
        if args.dataset == "nusc" and "instoken" in sample:
            samples_of_ins = dataset.anntokens_per_ins[sample["instoken"]]
            if len(samples_of_ins) > 1:
                order = list(range(len(samples_of_ins)))
                rng.shuffle(order)
                for ind in order:
                    tok, cam_id = samples_of_ins[ind]
                    if tok != sample["anntoken"] or cam_id != sample["cam"]:
                        perm_sample = dataset[dataset.all_valid_samples.index([tok, cam_id])]
                        perm_img = to_dev(perm_sample["img"])[None]
                        perm_mask = to_dev(perm_sample["mask"])[None]
                        perm_depth = to_dev(perm_sample["depth"])[None]
                        Kp = perm_sample["K"]
                        perm_center = to_dev(Kp[None, :2, 2]) + 0.5
                        perm_pose_params = pose_params_from_matrix(
                            to_dev(cam_pose_to_render_frame(perm_sample["cam_pose"],
                                                            flipped))[None],
                            to_dev([Kp[0, 0]]), flipped)
                        break
        rand_rot = None
        if args.dataset in ("kitti", "waymo"):
            # One random rotation per object, reused at every checkpoint
            # step so the novel-view depth column is comparable across
            # steps (eval_kitti_persp.py:631-645 redraws one per call but
            # only composites it).
            rand_rot = random_rotation(rng).astype(np.float64)
        parts_ms["data"].append(data_ms + lap())

        def evaluate_at(step, z_cur, pose_cur):
            out, cam = render_for_eval(z_cur, pose_cur, target_center)
            pred = torch.clamp(out.rgb[..., :3], -1, 1)
            target = target_img[..., :3]
            with torch.no_grad():
                m = {
                    "psnr": image_metrics.psnr(pred / 2 + 0.5, target / 2 + 0.5,
                                               reduction="none", mask=target_mask_input)[None],
                    "ssim": image_metrics.ssim(pred / 2 + 0.5, target / 2 + 0.5,
                                               reduction="none"),
                    "lpips": lpips(pred, target).reshape(-1),
                    "rot_error": rotation_matrix_distance(cam, gt_cam2world),
                    "trans_error": torch.sqrt(torch.sum(torch.square(
                        invert_space(cam)[:, :3, 3] - invert_space(gt_cam2world)[:, :3, 3]
                    )))[None],
                }
                valid = gt_depth_mask & (target_mask_input > 0.5)
                m["depth_error"] = (torch.sum(torch.abs(gt_depth - out.depth) * valid)
                                    / torch.clamp_min(torch.sum(valid), 1))[None]
            out_p = None
            if perm_img is not None:
                # Cross-view metrics against the other annotation
                # (reference: eval_nusc_persp.py:712-760).
                out_p, _ = render_for_eval(z_cur, perm_pose_params, perm_center)
                pred_p = torch.clamp(out_p.rgb[..., :3], -1, 1)
                with torch.no_grad():
                    m["psnr_random"] = image_metrics.psnr(
                        pred_p / 2 + 0.5, perm_img[..., :3] / 2 + 0.5, reduction="none",
                        mask=perm_mask)[None]
                    m["ssim_random"] = image_metrics.ssim(
                        pred_p / 2 + 0.5, perm_img[..., :3] / 2 + 0.5, reduction="none")
                    m["lpips_random"] = lpips(pred_p, perm_img[..., :3]).reshape(-1)
                    valid_p = (perm_depth > 0) & (perm_mask > 0.5)
                    m["depth_error_random"] = (
                        torch.sum(torch.abs(perm_depth - out_p.depth) * valid_p)
                        / torch.clamp_min(torch.sum(valid_p), 1))[None]
            elif rand_rot is not None:
                # Random-rotation novel view (kitti/waymo): the fitted
                # camera perturbed; its depth truth is this view's LiDAR
                # reprojected through the same perturbation (fitted ~ true
                # camera, as the front-view depth error assumes). No image
                # exists there: the image metrics are NaN columns.
                cam_c, focal_c = build_camera(pose_cur, flipped)
                w2c_p = invert_space(cam_c).detach().cpu().numpy().astype(np.float64)
                w2c_p[0, :3, :3] = w2c_p[0, :3, :3] @ rand_rot
                perm_params = pose_params_from_matrix(
                    invert_space(to_dev(w2c_p.astype(np.float32))), focal_c, flipped)
                out_p, _ = render_for_eval(z_cur, perm_params, target_center)
                nan = torch.full((1,), float("nan"))
                m["psnr_random"] = m["ssim_random"] = m["lpips_random"] = nan
                M = w2c_p[0] @ cam_c.detach().cpu().numpy().astype(np.float64)[0]
                gt_p = reproject_depth(sample["depth"], np.asarray(K, np.float64), M)
                valid_p = (gt_p > 0) & (out_p.mask[0].cpu().numpy() > 0.5)
                err = (np.sum(np.abs(gt_p - out_p.depth[0].cpu().numpy()) * valid_p)
                       / max(int(valid_p.sum()), 1))
                m["depth_error_random"] = np.asarray([np.float32(err)])
            mh = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in m.items()}
            report.add(step, mh)
            part("eval")
            return mh, out, out_p

        mh, out_last, out_p_last = evaluate_at(0, z_, pose_params)
        z_cur, pose_cur = z_, pose_params
        generator = torch.Generator(device=dev).manual_seed(idx)
        done = 0
        for step in checkpoint_steps[1:]:
            # A fresh Adam per segment, as the JAX driver's invert call
            # builds its optimizer; renders go through the crop's principal
            # point like every metric render (eval_nusc_persp.py:1258).
            z_cur, pose_cur, _ = invert(z_cur, pose_cur, target_img, generator=generator,
                                        center=target_center, n_steps=step - done)
            done = step
            part("refine")
            mh, out_last, out_p_last = evaluate_at(step, z_cur, pose_cur)

        if args.inv_export_demo_sample:
            if out_p_last is None:
                # No second annotation of this instance: novel view = the
                # recovered camera perturbed by a random rotation
                # (reference: eval_nusc_persp.py:694-708).
                cam_f, focal_f = build_camera(pose_cur, flipped)
                w2c_p = invert_space(cam_f).cpu().numpy()
                w2c_p[0, :3, :3] = w2c_p[0, :3, :3] @ random_rotation(rng)
                pose_params_p = pose_params_from_matrix(invert_space(to_dev(w2c_p)), focal_f,
                                                        flipped)
                out_p_last, _ = render_for_eval(z_cur, pose_params_p, target_center)
            # Per-object side-by-side composite at the final checkpoint
            # step (reference: eval_nusc_persp.py:553-802).
            export_driving_demo(
                args, config_ds, idx, niter, sample,
                None if coords is None else coords.cpu().numpy(),
                None if mask_pred is None else mask_pred.cpu().numpy(), mh,
                _host(out_last), _host(out_p_last),
                perm_target=None if perm_img is None else perm_img.cpu().numpy())
        objects += 1

        if (idx + 1) % 20 == 0 or idx + 1 == n_objects:
            elapsed = (time.time() - t0) / (idx + 1)
            print(f"[{idx + 1}/{n_objects}] {elapsed:.2f} s/obj")
            report.save(os.path.join(report_dir, "report_checkpoint"))

    stats = {"objects": objects, "seconds": time.time() - t0, "parts_ms": parts_ms,
             "steps": niter, "report_dir": report_dir}
    report.save(os.path.join(report_dir, "report"))
    print(report.summary())
    return stats


if __name__ == "__main__":
    main()
