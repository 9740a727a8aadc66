"""GAN training driver: `python -m nerf_from_image_tpu_torch.train`.

Counterpart of train.py, the JAX package's driver (the reference's
`python run.py --dataset X` path), with the same command-line flags plus
`--device` (default 'cuda', which raises without a card): it loads the
dataset into host memory, runs SDF pretraining, then alternates G steps
(even iterations) and D steps (odd ones) of engine/gan.py, printing im/s
and the losses and writing TensorBoard scalars, and saves one `.pth`
checkpoint per save under <root_path>/gan_checkpoints/<experiment>/:
checkpoint_latest.pth every --display_every iterations and
checkpoint_<N>.pth every 50,000 and at the end. A checkpoint's
'model_ema' is the EMA generator in the reference's names, which the
inversion driver's --resume_from reads.

Every --display_every iterations the train-time evaluation runs
(engine/gan_eval.py) when NFI_INCEPTION_WEIGHTS names pytorch-fid's
Inception weights or under --use_encoder: the generation FID of the
fixed z_fid latents at the train-eval split's poses ('fid',
'generation/fid_untrunc'), or in encoder-conditional mode the
reconstruction metrics of the front and random views
('reconstruction/{psnr,ssim,lpips,iou}[_test]_{front,random}', and with
Inception 'reconstruction/fid_{front,random}view[_test]'), on the
train-eval split and, where the dataset has one, the test split; the
first batch's renders go to the 'img/eval_{rgb,depth,mask}' grids. A new
best FID saves checkpoint_best.pth and best_fid.json, which a resumed run
reads back.

Batches come from StepIndexedSampler draws 4i, 4i+1 (and 4i+2, 4i+3 in
dual mode) and every random draw of iteration i from one torch.Generator
seeded from (1234, i) (SDF pretraining step j: (4321, j)), so the run is a
pure function of the iteration: a resume reproduces the straight run
with no saved random state.

Example (random weights, on the CPU):
  python -m nerf_from_image_tpu_torch.train --dataset synthetic \\
      --resolution 16 --batch_size 4 --iterations 4 --max_images 8 \\
      --sdf_pretrain_steps 2 --device cpu

Not ported yet, and refused at start-up with an error naming their
ROADMAP.md item: more than one device (--chips, --gpus, --multihost) and
orbax checkpoints (a --resume_from that is not a .pth file or a
directory of them).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch.utils.device import resolve_device, set_strict_f32, to_device

PRINT_ITERATION = 3  # the JAX driver's first print, after its compiles


def seeded_generator(device: torch.device, *key: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from the integer tuple `key`."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & (2**63 - 1))


def make_train_eval(args, config_ds, train_split, train_eval_split, test_split,
                    render_config, model, inception_weights: Optional[str],
                    device) -> Callable[[], Dict[str, object]]:
    """The training-time evaluate() of the (EMA) generator `model`:
    a function () -> {scalar name: value, 'fid': the run's FID (the
    random-view reconstruction FID in encoder mode) or None,
    'first_batch': the first batch's renders}. Real statistics come from
    the Inception weights at `inception_weights` (None: no FID)."""
    from nerf_from_image_tpu_torch.data.splits import (
        compute_eval_indices,
        compute_view_perm,
        draw_eval_latents,
    )
    from nerf_from_image_tpu_torch.engine import gan_eval
    from nerf_from_image_tpu_torch.models.lpips import make_lpips

    inception = real_stats = test_real_stats = None
    if inception_weights:
        inception = gan_eval.load_fid_inception(inception_weights, device)
        real_stats = gan_eval.compute_real_fid_stats(inception, train_eval_split.images,
                                                     device=device)
    eval_indices = compute_eval_indices(train_eval_split)
    z_fid = draw_eval_latents(len(eval_indices), args.latent_dim)
    eval_perm = compute_view_perm(eval_indices, config_ds.views_per_object)
    # The held-out test split: its evaluation indices, their view pairing
    # and a second z draw.
    test_eval_indices = test_eval_perm = z_fid_test = None
    if args.use_encoder and config_ds.views_per_object_test and test_split is not None \
            and len(test_split):
        test_eval_indices = compute_eval_indices(test_split)
        test_eval_perm = compute_view_perm(test_eval_indices, config_ds.views_per_object_test)
        z_fid_test = draw_eval_latents(len(test_eval_perm), args.latent_dim, seed=4322)
        print(f"Evaluating test set on {len(test_eval_indices)} images")
        if inception is not None:
            test_real_stats = gan_eval.compute_real_fid_stats(inception, test_split.images,
                                                              device=device)
    # Encoder-conditional reconstructions are also scored with LPIPS.
    lpips = make_lpips(torch.Generator().manual_seed(98), device=device) \
        if args.use_encoder else None
    recon_fn = gan_eval.make_recon_eval_fn(render_config, model, inception, lpips, device)

    def run(split, indices, z, stats, **kw):
        return gan_eval.evaluate_recon(recon_fn, z, split, indices, stats,
                                       use_labels=args.use_class, device=device, **kw)

    def evaluate() -> Dict[str, object]:
        if not args.use_encoder:
            r = run(train_eval_split, eval_indices, z_fid, real_stats)
            return {"fid": r.get("fid"), "generation/fid_untrunc": r.get("fid"),
                    "first_batch": r["first_batch"]}

        out: Dict[str, object] = {}

        def run_mode(split, indices, perm, z, mode, views, inputs, suffix, stats):
            r = run(split, indices, z, stats, recon_mode=mode,
                    perm_indices=perm if mode == "random" else None,
                    views_per_object=views, input_images=inputs)
            for k, v in r.items():
                if k not in ("first_batch", "n_images", "fid"):
                    out[f"reconstruction/{k}{suffix}_{mode}"] = v
            if stats is not None and r.get("fid") is not None:
                out[f"reconstruction/fid_{mode}view{suffix}"] = r["fid"]
            return r

        rf = run_mode(train_eval_split, eval_indices, eval_perm, z_fid, "front",
                      config_ds.views_per_object, train_split.images, "", real_stats)
        rr = run_mode(train_eval_split, eval_indices, eval_perm, z_fid, "random",
                      config_ds.views_per_object, train_split.images, "", real_stats)
        out["first_batch"] = rf["first_batch"]
        # The run's FID is the random-view reconstruction FID.
        out["fid"] = rr.get("fid", rf.get("fid"))
        if test_eval_indices is not None:
            # The test split's FIDs are logged too (PARITY.md section 2.6).
            for mode in ("front", "random"):
                run_mode(test_split, test_eval_indices, test_eval_perm, z_fid_test, mode,
                         config_ds.views_per_object_test, test_split.images, "_test",
                         test_real_stats)
        return out

    return evaluate


def main(argv=None) -> Dict[str, object]:
    """Runs the training driver on the command line `argv` (sys.argv[1:]
    when None). Returns the run: {'start_iteration', 'iterations',
    'seconds' (wall time of the GAN loop, up to a device synchronize at
    its end), 'pretrain_steps' (SDF pretraining steps run), 'metrics'
    (the last G and D steps', as floats), 'eval' (the last train-time
    evaluation's scalars, 'fid' included), 'best_fid', 'checkpoint_dir',
    'last_checkpoint'}. As the JAX driver does, the loop reads the
    metrics from the device only at print iterations."""
    from nerf_from_image_tpu_torch import arguments
    from nerf_from_image_tpu_torch.data.loaders import get_train_overrides, load_dataset
    from nerf_from_image_tpu_torch.data.splits import StepIndexedSampler
    from nerf_from_image_tpu_torch.engine import gan
    from nerf_from_image_tpu_torch.engine.render import RenderConfig
    from nerf_from_image_tpu_torch.models.discriminator import Discriminator
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.utils import checkpoint as ckpt
    from nerf_from_image_tpu_torch.utils.tb import Logger

    args = arguments.parse_args(argv)
    if args.run_inversion:
        # Reference CLI compatibility: --run_inversion skips GAN training
        # and runs the hybrid-inversion driver.
        from nerf_from_image_tpu_torch import invert

        return invert.main(argv)
    from nerf_from_image_tpu_torch.engine.gan_eval import inception_weights_path
    from nerf_from_image_tpu_torch.invert import refuse_multi_device

    refuse_multi_device(args)
    if args.resume_from:
        if not os.path.exists(args.resume_from):
            raise ValueError(f"Specified checkpoint {args.resume_from} does not exist!")
        resume_path = ckpt.resolve_checkpoint_path(args.resume_from)
    dev = resolve_device(args.device)
    set_strict_f32()  # the reference pins f32
    if args.dataset == "autodetect":
        raise ValueError("--dataset required for training")
    overrides = get_train_overrides(args.dataset)
    if args.augment_p == 0:
        args.augment_p = overrides.augment_p
        args.augment_ada = args.augment_ada or overrides.augment_ada
    args.supervise_alpha = args.supervise_alpha or overrides.supervise_alpha
    args.use_viewdir = args.use_viewdir or overrides.use_viewdir
    if args.iterations == 300000:
        args.iterations = overrides.iterations
    # Dataset presets apply only where the flag is at its default.
    if args.disable_stylegan_noise:
        args.disable_stylegan_noise = overrides.disable_stylegan_noise
    if args.r1 == 5.0:
        args.r1 = overrides.r1

    experiment_name = arguments.suggest_experiment_name(args)
    print("Experiment:", experiment_name)
    checkpoint_dir = os.path.join(args.root_path, "gan_checkpoints", experiment_name)

    config_ds, train_split, train_eval_split, test_split = load_dataset(
        args.dataset, args.data_path, resolution=args.resolution,
        augment_p=args.augment_p, use_class=args.use_class, max_images=args.max_images,
        # Encoder mode also evaluates the reconstructions of the test split.
        need_test=bool(args.use_encoder))

    if args.perturb_poses > 0:
        # Pose-robustness ablation.
        from nerf_from_image_tpu_torch.pose.pose import perturb_poses

        print("Perturbing poses", args.perturb_poses)
        p_pose, p_focal, p_bbox = perturb_poses(
            train_split.tform_cam2world, args.perturb_poses, train_split.focal_length,
            train_split.bbox)
        shared = train_eval_split is train_split or (
            train_eval_split.tform_cam2world.shape == train_split.tform_cam2world.shape)
        train_split = dataclasses.replace(train_split, tform_cam2world=p_pose,
                                          focal_length=p_focal, bbox=p_bbox)
        if shared:
            train_eval_split = dataclasses.replace(
                train_eval_split, tform_cam2world=p_pose, focal_length=p_focal, bbox=p_bbox)
        else:
            e_pose, e_focal, e_bbox = perturb_poses(
                train_eval_split.tform_cam2world, args.perturb_poses,
                train_eval_split.focal_length, train_eval_split.bbox)
            train_eval_split = dataclasses.replace(
                train_eval_split, tform_cam2world=e_pose, focal_length=e_focal, bbox=e_bbox)
    print(f"Device {dev}, dataset {len(train_split)} images")

    num_classes = train_split.num_classes if args.use_class else None
    nc = 4 if args.supervise_alpha else 3
    model = Generator(
        latent_dim=args.latent_dim, scene_range=config_ds.scene_range,
        attention_values=args.attention_values, use_viewdir=args.use_viewdir,
        use_encoder=args.use_encoder, use_sdf=args.use_sdf, num_classes=num_classes,
        device=dev, generator=torch.Generator().manual_seed(1234))
    disc = disc2 = None
    if not (args.dual_discriminator_l1 or args.dual_discriminator_mse):
        disc = Discriminator(
            resolution=args.resolution, nc=nc, camera_flipped=config_ds.camera_flipped,
            conditional_pose=args.conditional_pose, use_encoder=args.use_encoder,
            num_classes=num_classes, device=dev, generator=torch.Generator().manual_seed(1235))
    if args.dual_discriminator:
        # The second discriminator is pose-conditioned, without image or
        # class embedding.
        disc2 = Discriminator(
            resolution=args.resolution, nc=nc, camera_flipped=config_ds.camera_flipped,
            conditional_pose=args.conditional_pose, device=dev,
            generator=torch.Generator().manual_seed(1236))
    config = gan.GANTrainConfig(
        batch_size=args.batch_size, latent_dim=args.latent_dim, lr_g=args.lr_g,
        lr_d=args.lr_d, clip_gradient_norm=args.clip_gradient_norm, r1=args.r1,
        eikonal=args.eikonal, tv=args.tv, entropy=args.entropy,
        path_length_regularization=args.path_length_regularization,
        supervise_alpha=args.supervise_alpha, conditional_pose=args.conditional_pose,
        white_background=config_ds.white_background,
        camera_flipped=config_ds.camera_flipped, is_highres=config_ds.is_highres,
        augment_p=args.augment_p, augment_ada=args.augment_ada,
        ada_target=args.ada_target,
        noise_mode="none" if args.disable_stylegan_noise else "random",
        use_sdf=args.use_sdf, use_encoder=args.use_encoder, use_class=args.use_class,
        dual_discriminator=args.dual_discriminator,
        dual_l1=args.dual_discriminator_l1, dual_mse=args.dual_discriminator_mse)
    render_config = RenderConfig(
        resolution=args.resolution,
        depth_samples_per_ray=64 if args.fine_sampling else 128,
        fine_sampling=args.fine_sampling, scene_range=config_ds.scene_range,
        white_background=config_ds.white_background, use_viewdir=args.use_viewdir,
        query_chunk=args.query_chunk or None,  # 0 = unchunked
        plane_dtype=None if args.plane_dtype == "float32" else args.plane_dtype,
        merge_mode=args.merge_mode,
        # Legal on the G step's main render: path_length differentiates the
        # synthesis alone and the volume regularizers decode their own
        # samples through the grid-sample branch, so no second derivative
        # reaches the splat op.
        plane_splat=args.plane_splat)
    state = gan.init_gan_state(config, model, disc, disc2)

    start_iter = 0
    latest = resume_path if args.resume_from else ckpt.latest_checkpoint(checkpoint_dir)
    if latest is not None:
        print("Resuming from", latest)
        restored = ckpt.load_train_checkpoint(latest)
        restored_iter = int(restored["iteration"])
        if not args.resume_from and restored_iter < config.blur_warmup_iters:
            # The warm-up was not completed: train from scratch instead.
            print("Aborting resume (training from scratch)")
        else:
            state.load_state_dict(restored)
            start_iter = restored_iter
        del restored

    sampler = StepIndexedSampler(len(train_split), seed=1234)

    def host_batch(draw: int, with_images: bool) -> Dict[str, torch.Tensor]:
        sel = train_split.select(sampler(draw, args.batch_size))

        def put(x, dtype=torch.float32):
            return to_device(x, dev, dtype)

        batch = {"pose": put(sel.tform_cam2world)}
        if sel.focal_length is not None:
            batch["focal"] = put(sel.focal_length)
        if sel.center is not None:
            batch["center"] = put(sel.center)
        if args.use_class and sel.classes is not None:
            batch["classes"] = put(sel.classes, torch.long)
        if with_images or args.use_encoder:
            batch["images"] = put(sel.images[..., :nc])
            if with_images and sel.images_highres is not None:
                batch["images_highres"] = put(sel.images_highres[..., :nc])
        return batch

    pretrain_steps = 0
    if args.use_sdf and start_iter == 0:
        # Conditional modes pretrain with their conditioning: encoder mode
        # random train images, class mode random labels.
        print("SDF pretraining...")
        pre_opt = gan.make_pretrain_optimizer(model, args.lr_g)
        for i in range(args.sdf_pretrain_steps):
            g = seeded_generator(dev, 4321, i)
            images = labels = None
            if args.use_encoder:
                idx = torch.randint(0, len(train_split), (args.batch_size,), generator=g,
                                    device=dev)
                images = torch.as_tensor(
                    train_split.select(idx.cpu().numpy()).images[..., :3],
                    dtype=torch.float32).to(dev)
            if args.use_class:
                labels = torch.randint(0, train_split.num_classes, (args.batch_size,),
                                       generator=g, device=dev)
            loss = gan.sdf_pretrain_step(config, model, pre_opt, g, cond_image=images,
                                         labels=labels)
            if i % 100 == 0:
                print(f"  [{i}] sdf pretrain loss {float(loss):.4f}")
        pretrain_steps = args.sdf_pretrain_steps
        del pre_opt
        state.ema.load_state_dict(model.state_dict())
        print("SDF pretraining done.")

    writer = Logger(os.path.join(args.root_path, "gan_logs", experiment_name))
    # The train-time evaluation runs where FID is possible (Inception
    # weights) or encoder-mode reconstruction metrics apply.
    inception_weights = inception_weights_path()
    train_eval = None
    if inception_weights or args.use_encoder:
        train_eval = make_train_eval(args, config_ds, train_split, train_eval_split,
                                     test_split, render_config, state.ema,
                                     inception_weights, dev)
    # best_fid survives restarts through a sidecar file.
    best_fid = float("inf")
    best_fid_path = os.path.join(checkpoint_dir, "best_fid.json")
    if start_iter > 0 and os.path.exists(best_fid_path):
        with open(best_fid_path) as f:
            best_fid = float(json.load(f)["best_fid"])
        print(f"Restored best_fid {best_fid:.3f}")
    eval_metrics: Dict[str, object] = {}
    display_every = args.display_every or min(5000, max(50, args.iterations // 10))
    print_every = min(1000, max(10, args.iterations // 40))
    last: Dict[str, Dict[str, torch.Tensor]] = {}
    last_checkpoint = None
    t_start = time.time()
    for i in range(start_iter, args.iterations):
        g = seeded_generator(dev, 1234, i)
        # A 4x stride of draws, so that dual mode's second real and fake
        # draws never meet the first ones.
        if i % 2 == 0:
            b2 = host_batch(4 * i + 2, False) if args.dual_discriminator else None
            metrics = gan.g_step(config, render_config, state, host_batch(4 * i, False), g, b2)
        else:
            rb2 = fb2 = None
            if args.dual_discriminator:
                rb2 = host_batch(4 * i + 2, True)
                fb2 = host_batch(4 * i + 3, False)
            metrics = gan.d_step(config, render_config, state, host_batch(4 * i, True),
                                 host_batch(4 * i + 1, False), g, rb2, fb2)
        last["g" if i % 2 == 0 else "d"] = metrics
        if i == PRINT_ITERATION or (i + 1) % print_every == 0 or (i + 1) % display_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            imps = args.batch_size * (i + 1 - start_iter) / (time.time() - t_start)
            print(f"[{i}] im/s {imps:.2f}", m)
            writer.scalars(m, i, prefix="loss/")
            writer.scalar("img_per_sec", imps, i)
            if (i + 1) % display_every == 0:
                if train_eval is not None:
                    eval_metrics = train_eval()
                    best_fid = _log_eval(writer, eval_metrics, i, best_fid, checkpoint_dir,
                                         state)
                last_checkpoint = os.path.join(checkpoint_dir, "checkpoint_latest.pth")
                ckpt.save_train_checkpoint(last_checkpoint, state.state_dict())
        if (i + 1) % 50000 == 0 or i + 1 == args.iterations:
            last_checkpoint = os.path.join(checkpoint_dir, f"checkpoint_{i + 1}.pth")
            ckpt.save_train_checkpoint(last_checkpoint, state.state_dict())
            print("Saved checkpoint", last_checkpoint)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.time() - t_start
    writer.flush()
    print("Training complete.")
    return {"start_iteration": start_iter, "iterations": args.iterations,
            "seconds": seconds, "pretrain_steps": pretrain_steps,
            "metrics": {k: {n: float(v) for n, v in m.items()} for k, m in last.items()},
            "eval": {k: v for k, v in eval_metrics.items() if k != "first_batch"},
            "best_fid": best_fid, "checkpoint_dir": checkpoint_dir,
            "last_checkpoint": last_checkpoint}


def _log_eval(writer, metrics: Dict[str, object], i: int, best_fid: float,
              checkpoint_dir: str, state) -> float:
    """Writes one evaluation's scalars and image grids; on a new best FID
    saves checkpoint_best.pth and best_fid.json. Returns the best FID."""
    from nerf_from_image_tpu_torch.utils import checkpoint as ckpt

    fid = metrics.get("fid")
    if fid is not None:
        print(f"[{i}] FID {fid:.2f}")
        writer.scalar("fid", fid, i)
    for k, v in metrics.items():
        if k not in ("fid", "first_batch") and v is not None:
            writer.scalar(k, v, i)
    fb = metrics.get("first_batch") or {}
    if "rgb" in fb:
        writer.images("img/eval_rgb", fb["rgb"], i)
    if "depth" in fb:
        d = fb["depth"]
        writer.images("img/eval_depth", (d / max(float(d.max()), 1e-6))[..., None], i)
    if "mask" in fb:
        writer.images("img/eval_mask", fb["mask"][..., None], i)
    if fid is not None and fid < best_fid:
        best_fid = fid
        ckpt.save_train_checkpoint(os.path.join(checkpoint_dir, "checkpoint_best.pth"),
                                   state.state_dict())
        with open(os.path.join(checkpoint_dir, "best_fid.json"), "w") as f:
            json.dump({"best_fid": best_fid}, f)
    return best_fid


if __name__ == "__main__":
    main()
