"""The cases of tests/test_torch_parallel.py: the port's data-parallel
paths at tiny widths, run once on one rank (in the test process) and once
on every rank of a two-process gloo group (`worker`, spawned), so that the
two runs can be compared. This module imports no JAX, so that the spawned
processes start quickly.

Each case returns host arrays and floats: the losses and metrics, the
gradients each optimizer step received (after the all-reduce), the
render's maps and gradients, the drivers' returns and report rows.
"""

import contextlib
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from nerf_from_image_tpu_torch import eval_driving, invert, train, train_encoder
from nerf_from_image_tpu_torch.data import driving_fixtures
from nerf_from_image_tpu_torch.engine import coord_regressor as tcr
from nerf_from_image_tpu_torch.engine import gan
from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.models import discriminator as tdisc
from nerf_from_image_tpu_torch.models import encoder as tenc
from nerf_from_image_tpu_torch.models import generator as tgen
from nerf_from_image_tpu_torch.models import stylegan as tsg
from nerf_from_image_tpu_torch.parallel import mesh

TINY_G = dict(w_dim=64, plane_channels=8, synthesis_resolution=16, channel_base=512,
              channel_max=64)
GEN = dict(latent_dim=64, scene_range=0.55, use_sdf=True, attention_values=4, **TINY_G)
TINY_D = dict(channel_base=512, channel_max=32)
DEPTHS = (1, 1, 1, 1)
B, RES = 8, 16  # the global batch of the step cases: 4 a rank on two
WORLD = 2
THREADS = 1
_Generator, _Backbone, _Encoder = tgen.Generator, tsg.DiscriminatorBackbone, tenc.BootstrapEncoder


@contextlib.contextmanager
def tiny_models():
    """The drivers' generator, discriminator and encoder at tiny widths,
    and every optimizer step's gradients recorded (the list it yields)."""
    recorded = []
    step = gan.Optimizer.step

    def record(self, grads):
        recorded.append([g.detach().cpu().numpy().copy() for g in grads])
        return step(self, grads)

    patches = ((tgen, "Generator", functools.partial(_Generator, **TINY_G)),
               (tdisc, "DiscriminatorBackbone", functools.partial(_Backbone, **TINY_D)),
               (tenc, "BootstrapEncoder", functools.partial(_Encoder, backbone_depths=DEPTHS)),
               (gan.Optimizer, "step", record))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, v in patches:
            setattr(m, n, v)
        yield recorded
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _cameras(rng, n):
    mats = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        m = np.eye(4)
        m[:3, :3] = q
        m[:3, 3] = q @ np.array([0.0, 0.0, 2.5])
        mats.append(m)
    return np.stack(mats).astype(np.float32), (1.0 + rng.random(n)).astype(np.float32)


def _local(batch):
    """The rank's rows of a global host batch, as CPU tensors."""
    return {k: torch.as_tensor(v) for k, v in mesh.shard_batch(batch, B).items()}


def _models(seed=7):
    model = tgen.Generator(**GEN, device="cpu", generator=torch.Generator().manual_seed(seed))
    disc = tdisc.Discriminator(resolution=RES, nc=3, camera_flipped=False,
                               conditional_pose=True, device="cpu",
                               generator=torch.Generator().manual_seed(seed + 1))
    return model, disc


def _render_config(**kw):
    return RenderConfig(**{**dict(resolution=RES, depth_samples_per_ray=8, query_chunk=None,
                                  scene_range=0.55 * (1 - 1e-4), white_background=True,
                                  plane_splat=True), **kw})


def case_g_step(recorded):
    """One G step at iteration 4000 (path length, TV and entropy weighted)
    with fixed-p camera augmentation."""
    model, disc = _models()
    config = gan.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"],
                                white_background=True, augment_p=0.5,
                                path_length_regularization=True)
    state = gan.init_gan_state(config, model, disc)
    state.iteration = 4000
    pose, focal = _cameras(np.random.default_rng(15), B)
    metrics = gan.g_step(config, _render_config(), state, _local({"pose": pose, "focal": focal}),
                         torch.Generator().manual_seed(16))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": recorded[-1],
            "ppl_running_avg": float(state.ppl_running_avg),
            "params": [_np(p) for p in model.parameters()]}


def case_d_step(recorded):
    """One D step with R1 and an ADA update (iteration 12,503)."""
    model, disc = _models()
    config = gan.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"],
                                white_background=True, augment_p=0.5, augment_ada=True)
    state = gan.init_gan_state(config, model, disc)
    state.iteration = 12503
    state.augment_p_eff.fill_(0.3)
    rng = np.random.default_rng(17)
    pose_r, focal_r = _cameras(rng, B)
    pose_f, focal_f = _cameras(rng, B)
    images = (rng.random((B, RES, RES, 3)) * 2 - 1).astype(np.float32)
    metrics = gan.d_step(config, _render_config(), state,
                         _local({"pose": pose_r, "focal": focal_r, "images": images}),
                         _local({"pose": pose_f, "focal": focal_f}),
                         torch.Generator().manual_seed(18))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": recorded[-1]}


def case_mbstd():
    """Discriminator logits of a global batch of 4, 2 a rank (not a
    multiple of the minibatch-std group of 4): the groups are the global
    batch's either way."""
    _, disc = _models()
    rng = np.random.default_rng(19)
    pose, focal = _cameras(rng, 4)
    images = (rng.random((4, RES, RES, 3)) * 2 - 1).astype(np.float32)
    local = {k: torch.as_tensor(v) for k, v in
             mesh.shard_batch({"pose": pose, "focal": focal, "images": images}, 4).items()}
    with mesh.sharded_draws():
        logits = disc(local["images"], local["pose"], None, local["focal"])
    return {"logits": mesh.gather_rows(_np(logits))}


def case_sdf(recorded):
    model, _ = _models()
    config = gan.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"])
    opt = gan.make_pretrain_optimizer(model, 0.0025)
    loss = gan.sdf_pretrain_step(config, model, opt, torch.Generator().manual_seed(20))
    return {"loss": float(loss), "grads": recorded[-1]}


def case_coord(recorded):
    """One distillation step at 32^2, a global batch of 4."""
    model = tgen.Generator(**{**GEN, "scene_range": 1.4}, device="cpu",
                           generator=torch.Generator().manual_seed(21)).requires_grad_(False)
    encoder = tenc.BootstrapEncoder(GEN["w_dim"], device="cpu",
                                    generator=torch.Generator().manual_seed(22))
    config = tcr.CoordRegressorConfig(latent_dim=GEN["latent_dim"])
    pose, focal = _cameras(np.random.default_rng(23), 4)
    batch = {k: torch.as_tensor(v) for k, v in
             mesh.shard_batch({"pose": pose, "focal": focal}, 4).items()}
    losses = tcr.coord_train_step(config, _render_config(resolution=32, scene_range=1.4),
                                  model, encoder, tcr.make_optimizer(config, encoder), batch,
                                  torch.Generator().manual_seed(24), device="cpu")
    return {"losses": {k: float(v) for k, v in losses.items()}, "grads": recorded[-1]}


def case_render():
    """The ray-sharded render (its rows split over the ranks, on one rank
    the whole image) and the gradients of a loss of its maps w.r.t. ws
    and the pose, averaged over ranks."""
    model, _ = _models()
    rng = np.random.default_rng(25)
    pose, focal = _cameras(rng, 2)
    ws = torch.as_tensor(rng.standard_normal((2, 1, GEN["w_dim"])).astype(np.float32))
    ws = ws.expand(2, model.num_ws, GEN["w_dim"]).clone().requires_grad_(True)
    pose = torch.as_tensor(pose).requires_grad_(True)
    out, _ = render(_render_config(shard_rays=True), model, pose, torch.as_tensor(focal), ws,
                    generator=torch.Generator().manual_seed(26), device="cpu")
    weights = torch.as_tensor(rng.standard_normal(out.rgb.shape).astype(np.float32))
    loss = torch.sum(out.rgb * weights) + torch.sum(out.depth) + torch.sum(out.mask)
    grads = mesh.all_reduce_mean(list(torch.autograd.grad(loss, (ws, pose))))
    return {"rgb": _np(out.rgb), "depth": _np(out.depth), "mask": _np(out.mask),
            "grad_ws": _np(grads[0]), "grad_pose": _np(grads[1])}


def split_in_process(case):
    """A case's two ranks run one after the other in this process, each on
    its rows and its block of the global draws, with the all-reduces left
    out; returns the ranks' mean of its 'grads' and 'losses'. What a group
    computes, summed in numpy's order."""
    parts = []
    saved = {n: getattr(mesh, n) for n in ("world_size", "rank", "all_reduce_mean",
                                            "mean_metrics")}
    try:
        mesh.all_reduce_mean = lambda tensors: tensors
        mesh.mean_metrics = lambda metrics: metrics
        mesh.world_size = lambda: WORLD
        for r in range(WORLD):
            mesh.rank = lambda r=r: r
            with tiny_models() as recorded:
                parts.append(case(recorded))
    finally:
        for n, v in saved.items():
            setattr(mesh, n, v)
    return {"grads": [np.mean(gs, axis=0) for gs in zip(*(p["grads"] for p in parts))],
            "losses": {k: float(np.mean([p["losses"][k] for p in parts]))
                       for k in parts[0]["losses"]}}


DRIVER_BASE = ["--dataset", "synthetic", "--max_images", "8", "--latent_dim", "64",
               "--device", "cpu"]


def case_train_driver(root, recorded):
    """train.main: one SDF pretraining step, a G and a D step at a global
    batch of 8."""
    run = train.main(DRIVER_BASE + [
        "--resolution", "16", "--batch_size", "8", "--iterations", "2",
        "--sdf_pretrain_steps", "1", "--path_length_regularization", "--plane_splat", "true",
        "--query_chunk", "4096", "--root_path", os.path.join(root, "train")])
    return {"metrics": run["metrics"], "grads": list(recorded)}


def case_train_encoder_driver(root, recorded):
    run = train_encoder.main(DRIVER_BASE + [
        "--resolution", "32", "--batch_size", "4", "--iterations", "1",
        "--root_path", os.path.join(root, "coord")])
    return {"losses": run["losses"], "grads": list(recorded)}


def _report(report_dir):
    with np.load(os.path.join(report_dir, "report.npz")) as f:
        return {k: f[k] for k in f.files if k != "__metric_notes__"}


def case_invert_driver(root, batch_size):
    """invert.main, 2 mse steps a batch: a global batch of 4 (--batch_size
    16 on one rank, 8 on each of two: batch_size // 4 a rank)."""
    stats = invert.main(DRIVER_BASE + [
        "--resolution", "16", "--batch_size", str(batch_size), "--inv_steps", "2",
        "--inv_loss", "mse", "--root_path", os.path.join(root, "invert")])
    return {"images": stats["images"], "report": _report(stats["report_dir"])}


def case_eval_driving(root):
    """eval_driving.main on a nuScenes tree of 4 annotations (2 cars in 2
    views), 2 steps an object: the objects split 2 and 2."""
    tree = os.path.join(root, "nusc")
    if mesh.is_main():
        driving_fixtures.build_nusc_tree(tree, 320, 180, lidar_points=6800)
    mesh.barrier()
    stats = eval_driving.main([
        "--dataset", "nusc", "--nusc_data_dir", tree, "--driving_index_file",
        os.path.join(tree, "v1.0-mini", "index.json"), "--resolution", "16",
        "--inv_steps", "2", "--latent_dim", "64", "--device", "cpu",
        "--root_path", os.path.join(root, "driving")])
    return {"objects": stats["objects"], "report": _report(stats["report_dir"])}


def run_all(root, invert_batch_size):
    """Every case in order; the same calls on one rank and on each rank of
    a group."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)  # the ranks' and the one-rank run's sums alike
    try:
        return _run_all(root, invert_batch_size)
    finally:
        torch.set_num_threads(threads)


def _run_all(root, invert_batch_size):
    out = {}
    with tiny_models() as recorded:
        out["g_step"] = case_g_step(recorded)
        out["d_step"] = case_d_step(recorded)
        out["mbstd"] = case_mbstd()
        out["sdf"] = case_sdf(recorded)
        out["coord"] = case_coord(recorded)
        out["render"] = case_render()
        recorded.clear()
        out["train_driver"] = case_train_driver(root, recorded)
        recorded.clear()
        out["train_encoder_driver"] = case_train_encoder_driver(root, recorded)
    # The inversion drivers run the full-width generator: tiny for them too.
    with tiny_models():
        out["invert_driver"] = case_invert_driver(root, invert_batch_size)
        out["eval_driving"] = case_eval_driving(root)
    return out


def main(argv):
    """A stand-in entry point for mesh.spawn_local: joins the group as a
    driver does and reports it."""
    from nerf_from_image_tpu_torch import arguments

    mesh.maybe_init_multihost(arguments.parse_args(argv), "cpu")
    return {"rank": mesh.rank(), "world": mesh.world_size(), "backend": dist.get_backend(),
            "ranks": mesh.gather_objects(mesh.rank())}


def worker(rank, store, root, out_dir, timeout_s):
    """One rank of the group: joins it through the FileStore `store`,
    runs every case and saves its results as rank<r>.pt in out_dir."""
    os.environ.pop("NFI_INCEPTION_WEIGHTS", None)
    mesh.init_process_group(rank, WORLD, f"file://{store}", "cpu", timeout_s=timeout_s)
    try:
        torch.save(run_all(root, invert_batch_size=8), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
