"""CLI argument parsing and experiment naming.

Mirrors the reference's flag surface (reference: arguments.py:18-276) so a
user of the reference can drive this framework with the same commands. This
package's copy of the JAX package's arguments.py: the same flags, defaults
and post-processing, so one command line drives either package, plus
`--device` (the card by default; `--device cpu` runs the kernels' plain
versions on the CPU). More than one device: parallel/mesh.py.
"""

from __future__ import annotations

import argparse


def bool_flag(v) -> bool:
    """argparse `type=` for booleans: accepts true/false/1/0/yes/no (any
    case) and the empty string as False — `type=bool_flag` would parse the
    string "False" as True (reference arguments.py has the same footgun)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()

    # General settings
    parser.add_argument("--chips", type=int, default=0,
                        help="Number of devices: N > 1 without a launcher spawns N "
                             "local processes, one card each; under torchrun 0 or "
                             "the world size")
    parser.add_argument("--gpus", type=int, default=0,
                        help="Reference-CLI compatibility alias for --chips "
                             "(reference arguments.py:22-25)")
    parser.add_argument("--multihost", action="store_true",
                        help="Multi-host data parallelism: needs torchrun's "
                             "environment or COORDINATOR_ADDRESS with NFI_*")
    parser.add_argument("--dataset", type=str, default="autodetect",
                        help="Dataset among (shapenet_*, p3d_*, cub, "
                             "imagenet_*, carla, synthetic)")
    parser.add_argument("--xid", type=str, default="")
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--run_inversion", action="store_true")
    parser.add_argument("--resume_from", type=str)
    parser.add_argument("--root_path", type=str, default=".")
    parser.add_argument("--data_path", type=str, default="datasets")

    # Training settings
    parser.add_argument("--iterations", type=int, default=300000)
    parser.add_argument("--display_every", type=int, default=0,
                        help="Eval/checkpoint cadence override (0 = the "
                             "reference-scaled default; reference run.py:518 "
                             "fixes 5000)")
    parser.add_argument("--lr_g", type=float, default=0.0025)
    parser.add_argument("--lr_d", type=float, default=0.002)
    parser.add_argument("--dual_discriminator", action="store_true")
    parser.add_argument("--dual_discriminator_l1", action="store_true")
    parser.add_argument("--dual_discriminator_mse", action="store_true")
    parser.add_argument("--r1", type=float, default=5.0)
    parser.add_argument("--tv", type=float, default=0.5)
    parser.add_argument("--entropy", type=float, default=0.05)
    parser.add_argument("--eikonal", type=float, default=0.1)
    parser.add_argument("--supervise_alpha", action="store_true")
    parser.add_argument("--conditional_pose", type=bool_flag, default=True)
    parser.add_argument("--augment_p", type=float, default=0)
    parser.add_argument("--augment_ada", action="store_true")
    parser.add_argument("--ada_target", type=float, default=0.6)
    parser.add_argument("--path_length_regularization", action="store_true")
    parser.add_argument("--perturb_poses", type=float, default=0)
    parser.add_argument("--clip_gradient_norm", type=float, default=100.0)

    # Model settings
    parser.add_argument("--fine_sampling", type=bool_flag, default=True)
    parser.add_argument("--attention_values", type=int, default=10)
    parser.add_argument("--use_sdf", type=bool_flag, default=True)
    parser.add_argument("--use_encoder", action="store_true")
    parser.add_argument("--use_viewdir", action="store_true")
    parser.add_argument("--use_class", action="store_true")
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--disable_stylegan_noise", type=bool_flag, default=True)

    # Inversion params
    parser.add_argument("--inv_use_testset", action="store_true")
    parser.add_argument("--inv_use_imagenet_testset", action="store_true")
    parser.add_argument("--inv_use_separate", action="store_true")
    parser.add_argument("--inv_loss", type=str, default="vgg")
    parser.add_argument("--inv_gain_z", type=int, default=5)
    parser.add_argument("--inv_steps", type=int)
    parser.add_argument("--inv_no_split", action="store_true")
    parser.add_argument("--inv_no_optimize_pose", action="store_true")
    parser.add_argument("--inv_train_coord_only", action="store_true")
    parser.add_argument("--inv_encoder_only", action="store_true")
    parser.add_argument("--inv_export_demo_sample", action="store_true")
    parser.add_argument("--inv_manual_input_path", type=str)

    # Driving evals (nuScenes / KITTI / Waymo)
    parser.add_argument("--nusc_data_dir", default="datasets/NuScenes")
    parser.add_argument("--kitti_data_dir", default="datasets/KITTI")
    parser.add_argument("--waymo_data_dir", default="datasets/Waymo")
    parser.add_argument("--nusc_version", default="v1.0-mini")
    parser.add_argument("--max_num_samples", type=int, default=500)
    parser.add_argument("--external_pose_file", default=None)
    parser.add_argument("--driving_index_file", default=None,
                        help="override the packaged nuScenes eval-subset "
                             "index JSON (data/index/nusc.*.json)")
    parser.add_argument("--no_optimize_pose", action="store_true")
    parser.add_argument("--init_pose_type", default="pnp",
                        help="pnp (known intrinsics) | pnp_focal_search "
                             "(older eval_nusc.py protocol) | gt | external "
                             "(SUP-NeRF poses via --external_pose_file)")

    # Coord regressor
    parser.add_argument("--coord_resume_from", type=str)

    # Device and render knobs
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the run: 'cuda' (needs a card) "
                             "or 'cpu'")
    parser.add_argument("--query_chunk", type=int, default=131072)
    parser.add_argument("--plane_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Storage dtype of the gathered triplane tables"
                        " (all surrounding arithmetic stays float32)")
    parser.add_argument("--plane_splat", type=bool_flag, default=False,
                        help="Route triplane-sampling backwards through the"
                        " hand-written splat kernel (csrc/splat.cu,"
                        " kernels/splat.py) in every first-order render"
                        " backward. Fastest with --query_chunk 0"
                        " (unchunked) when device memory allows.")
    parser.add_argument("--merge_mode", type=str, default="pairwise",
                        choices=["pairwise", "sort"],
                        help="Coarse+fine combination: sort-free pairwise"
                        " compositing (fast) or the argsort merge oracle")
    parser.add_argument("--sdf_pretrain_steps", type=int, default=1000)
    parser.add_argument("--max_images", type=int, default=None,
                        help="Cap loaded dataset size (debug)")

    args = parser.parse_args(argv)

    if args.dual_discriminator_l1 and not args.dual_discriminator:
        args.dual_discriminator = True
    if args.dual_discriminator_mse and not args.dual_discriminator:
        args.dual_discriminator = True
    if args.inv_manual_input_path:
        args.inv_export_demo_sample = True
    if args.inv_export_demo_sample:
        args.run_inversion = True
    if args.gpus and not args.chips:
        args.chips = args.gpus
    return args


def suggest_experiment_name(args) -> str:
    """Config-derived experiment name (reference: arguments.py:222-276)."""
    name = "r" if args.use_encoder else "g"
    name += f"_{args.xid}" if args.xid else ""
    name += f"_{args.dataset}"
    name += (
        f"_res{args.resolution}_bs{args.batch_size}_d{args.latent_dim}"
        f"_lrg_{args.lr_g}_lrd_{args.lr_d}"
    )
    if args.r1 > 0:
        name += f"_r1_{args.r1}"
    if args.entropy > 0:
        name += f"_entropy_{args.entropy}"
    if args.tv > 0:
        name += f"_tv_{args.tv}"
    if args.dual_discriminator:
        name += "_dual"
        if args.dual_discriminator_mse:
            name += "_mse"
        elif args.dual_discriminator_l1:
            name += "_l1"
    name += "_fine" if args.fine_sampling else "_nofine"
    name += f"_sdf_eik{args.eikonal}" if args.use_sdf else "_nosdf"
    if args.attention_values > 0:
        name += f"_attn{args.attention_values}"
    name += "_alpha" if args.supervise_alpha else "_noalpha"
    name += "_pose" if args.conditional_pose else "_nopose"
    if args.perturb_poses > 0:
        name += f"_perturb{args.perturb_poses}"
    if args.augment_p > 0:
        name += f"_augment_p{args.augment_p}"
        if args.augment_ada:
            name += f"_ada{args.ada_target}"
    if args.use_viewdir:
        name += "_viewdir"
    if args.use_class:
        name += "_class"
    if args.path_length_regularization:
        name += "_ppl"
    if args.disable_stylegan_noise:
        name += "_nonoise"
    return name
