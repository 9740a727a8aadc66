"""Bootstrap-encoder training driver: `python -m nerf_from_image_tpu_torch.train_encoder`.

Counterpart of train_encoder.py, the JAX package's driver (the
reference's train_coord_regressor, run.py:1521-1706), with the same
command-line flags plus `--device` (default 'cuda', which raises without
a card): it distills the frozen EMA generator of a `.pth` checkpoint
(--resume_from: a reference checkpoint or one of the port's train
checkpoints, 'model_ema'; random weights from seed 0 without it) into
the SegFormer-B5 bootstrap encoder that predicts canonical coordinate
maps, masks and latents (engine/coord_regressor.py).

Cameras (pose, focal, center, bbox, classes) are the train split's, drawn
by StepIndexedSampler(seed=1234) at each iteration; z, the render's
samples and drop path come from one torch.Generator (seed 2), whose state
each checkpoint keeps. It prints the losses every 1,000 iterations and at
the end, and saves <root_path>/coords_checkpoints/c_<dataset>/
checkpoint_<N>.pth every 10,000 and at the end: 'model_coord' (the
encoder in the reference's names, which the inversion driver's
--coord_resume_from reads), 'optimizer_coord', 'iteration' and
'generator_state'. A run resumes from the newest of them, or from
--coord_resume_from; a reference-format file that holds only
'model_coord' warm-starts the weights alone.

More than one device (parallel/mesh.py): under torchrun or with --gpus N
every rank draws the global batch and keeps its rows, the gradients and
losses are averaged over the ranks, and rank 0 alone writes checkpoints.

Example (random weights, on the CPU):
  python -m nerf_from_image_tpu_torch.train_encoder --dataset synthetic \\
      --resolution 32 --batch_size 2 --iterations 3 --max_images 8 --device cpu
"""

from __future__ import annotations

import os
import time
from typing import Dict

import torch

from nerf_from_image_tpu_torch.parallel import mesh
from nerf_from_image_tpu_torch.utils.device import set_strict_f32, to_device

DEFAULT_ITERATIONS = 300000  # the flag's default, which means 120,000 here
ENCODER_ITERATIONS = 120000
LOG_EVERY = 1000
SAVE_EVERY = 10000


def main(argv=None) -> Dict[str, object]:
    """Runs encoder distillation on the command line `argv` (sys.argv[1:]
    when None). Returns {'start_iteration', 'iterations', 'seconds' (the
    loop's wall time up to a device synchronize), 'losses' (the last
    step's, as floats), 'checkpoint_dir', 'last_checkpoint'}."""
    from nerf_from_image_tpu_torch import arguments
    from nerf_from_image_tpu_torch.data.loaders import (
        autodetect_dataset,
        get_train_overrides,
        load_dataset,
    )
    from nerf_from_image_tpu_torch.data.splits import StepIndexedSampler
    from nerf_from_image_tpu_torch.engine import coord_regressor as cr
    from nerf_from_image_tpu_torch.engine.render import RenderConfig
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    from nerf_from_image_tpu_torch.models.generator import Generator
    from nerf_from_image_tpu_torch.utils import checkpoint as ckpt
    from nerf_from_image_tpu_torch.utils.tb import Logger
    from nerf_from_image_tpu_torch.utils.weights import (
        load_reference_encoder,
        load_reference_generator,
    )

    args = arguments.parse_args(argv)
    spawned, result = mesh.spawn_local(args, "nerf_from_image_tpu_torch.train_encoder", argv)
    if spawned:
        return result
    dev = mesh.maybe_init_multihost(args, args.device)
    mesh.local_batch(args.batch_size)  # W must divide the batch
    set_strict_f32()  # the reference pins f32
    if args.dataset == "autodetect":
        # The dataset from the checkpoint's name.
        if not args.resume_from:
            raise ValueError("--dataset or --resume_from required")
        args.dataset = autodetect_dataset(args.resume_from)
        print("Autodetected dataset:", args.dataset)
    # The training driver's per-dataset presets: CARLA's generator carries
    # the view-direction branch.
    overrides = get_train_overrides(args.dataset)
    args.use_viewdir = args.use_viewdir or overrides.use_viewdir
    args.supervise_alpha = args.supervise_alpha or overrides.supervise_alpha

    config_ds, train_split, _, _ = load_dataset(
        args.dataset, args.data_path, resolution=args.resolution, augment_p=0.0,
        use_class=args.use_class, max_images=args.max_images)

    model = Generator(
        latent_dim=args.latent_dim, scene_range=config_ds.scene_range,
        attention_values=args.attention_values, use_viewdir=args.use_viewdir,
        use_sdf=args.use_sdf,
        num_classes=train_split.num_classes if args.use_class else None,
        device=dev, generator=torch.Generator().manual_seed(0))
    if args.resume_from:
        load_reference_generator(model, ckpt.resolve_checkpoint_path(args.resume_from))
        print("Loaded generator from", args.resume_from)
    model.requires_grad_(False)

    # The w head regresses the generator's w (w_dim, not the z size).
    encoder = BootstrapEncoder(latent_dim=model.w_dim, separate_backbones=args.inv_use_separate,
                               device=dev, generator=torch.Generator().manual_seed(1))
    max_iters = args.iterations if args.iterations != DEFAULT_ITERATIONS else ENCODER_ITERATIONS
    config = cr.CoordRegressorConfig(
        latent_dim=args.latent_dim, max_iters=max_iters,
        # The rate drops tenfold at half the schedule.
        lr_drop_at=max_iters // 2)
    render_config = RenderConfig(
        resolution=args.resolution,
        depth_samples_per_ray=64 if args.fine_sampling else 128,
        fine_sampling=args.fine_sampling, scene_range=config_ds.scene_range,
        white_background=config_ds.white_background, use_viewdir=args.use_viewdir,
        query_chunk=args.query_chunk or None,
        plane_dtype=None if args.plane_dtype == "float32" else args.plane_dtype,
        merge_mode=args.merge_mode)
    opt = cr.make_optimizer(config, encoder)
    generator = torch.Generator(device=dev).manual_seed(2)

    ckpt_dir = os.path.join(args.root_path, "coords_checkpoints", f"c_{args.dataset}")
    start_iter = 0
    resume_path = args.coord_resume_from or ckpt.latest_checkpoint(ckpt_dir)
    if resume_path:
        state = ckpt.load_train_checkpoint(resume_path)
        if "optimizer_coord" not in state:
            # A reference-format encoder: its weights only; the optimizer
            # and the iteration start afresh.
            load_reference_encoder(encoder, resume_path)
            print(f"Warm-started encoder weights from {resume_path}")
        else:
            encoder.load_state_dict(state["model_coord"], strict=True)
            opt.load_state_dict(state["optimizer_coord"])
            generator.set_state(state["generator_state"])
            start_iter = int(state["iteration"])
            print(f"Resuming encoder training from {resume_path} (iteration {start_iter})")
        del state
    # Every rank starts from rank 0's weights and optimizer state.
    mesh.replicate_modules(encoder)
    mesh.replicate(opt.mu + opt.nu)

    sampler = StepIndexedSampler(len(train_split), seed=1234)

    writer = Logger(os.path.join(args.root_path, "gan_logs", f"c_{args.dataset}"))
    losses: Dict[str, torch.Tensor] = {}
    last_checkpoint = None
    t0 = time.time()
    for i in range(start_iter, config.max_iters):
        # The rank's rows of the global batch.
        sel = train_split.select(sampler(i, args.batch_size))
        batch = {"pose": sel.tform_cam2world, "focal": sel.focal_length, "center": sel.center,
                 "bbox": sel.bbox}
        if args.use_class:
            batch["classes"] = sel.classes
        batch = {k: to_device(v, dev, torch.long if k == "classes" else torch.float32)
                 for k, v in mesh.shard_batch(batch, args.batch_size).items() if v is not None}
        losses = cr.coord_train_step(config, render_config, model, encoder, opt, batch,
                                     generator, device=dev)
        if i % LOG_EVERY == 0 or i + 1 == config.max_iters:
            msg = " ".join(f"{k} {float(v):.5f}" for k, v in losses.items())
            print(f"[{i}] {msg}  ({(i + 1 - start_iter) / (time.time() - t0):.2f} it/s)")
            writer.scalars(losses, i, prefix="coords/")
        if (i + 1) % SAVE_EVERY == 0 or i + 1 == config.max_iters:
            last_checkpoint = os.path.join(ckpt_dir, f"checkpoint_{i + 1}.pth")
            ckpt.save_train_checkpoint(last_checkpoint, {
                "model_coord": {k: v.detach().cpu() for k, v in encoder.state_dict().items()},
                "optimizer_coord": opt.state_dict(),
                "iteration": i + 1,
                "generator_state": generator.get_state(),
            })
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    writer.flush()
    print("Encoder training complete.")
    return {"start_iteration": start_iter, "iterations": config.max_iters, "seconds": seconds,
            "losses": {k: float(v) for k, v in losses.items()},
            "checkpoint_dir": ckpt_dir, "last_checkpoint": last_checkpoint}


if __name__ == "__main__":
    main()
