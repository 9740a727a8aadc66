"""Where the time of one full-width step goes on the card.

    python -m nerf_from_image_tpu_torch.profile_step [--plane_dtype bfloat16]
        [--step render|inversion|gan] [--loss mse|vgg] [--count_syncs]

'render' is the bench step (Generator(512, 1.4, attention_values=10),
B=4, 128^2 rays, 64 coarse + 64 fine samples, pairwise merge, splat
backward, grads w.r.t. ws and pose). 'inversion' is one inversion step at
the same width with the loss of --loss ('vgg': LPIPS with random VGG16
features from a seed, 15 crop augmentations), from the average w and a
perturbed pose, towards a target rendered from a random latent (the cases
chip_smoke.py runs). 'gan' is one G step and one D step of the
train-synthetic cell (engine/gan.py: the bench generator and the
pose-conditioned discriminator at 128^2, B=8 synthetic images and
cameras, path length, splat backward in chunks of 131072, f32 planes;
iterations 2 and 3 of a run).
Warms up once, then traces two steps with torch.profiler and prints the
device time by kernel, the device-busy share of the wall time (busy: the
union of the device's activities), the host time of each of the port's
ranges (utils/trace.py) with the device-idle time of the gaps that began
while the host was in it (innermost range), and one JSON line with the
totals. With --count_syncs it runs one warm step under
torch.cuda.set_sync_debug_mode("warn") instead, and prints the
synchronizing calls (each waits until the device's queue has drained) by
call site and their total.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import warnings

import numpy as np
import torch

from nerf_from_image_tpu_torch.engine.inversion import (
    InversionConfig,
    make_invert_fn,
    pose_params_from_matrix,
)
from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.kernels import splat
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.utils import trace
from nerf_from_image_tpu_torch.utils.device import resolve_device, set_strict_f32

BATCH, RES, SAMPLES = 4, 128, 64
PKG_DIR = os.path.dirname(os.path.abspath(__file__))
# The warning of torch.cuda.set_sync_debug_mode("warn").
SYNC_WARNING = "called a synchronizing CUDA operation"


def bench_poses(batch: int, device) -> torch.Tensor:
    """B random rotations at distance 3 from seeded numpy (the bench camera)."""
    rng = np.random.default_rng(0)
    mats = []
    for _ in range(batch):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        m = np.eye(4)
        m[:3, :3] = q
        m[:3, 3] = q @ np.array([0.0, 0.0, 3.0])
        mats.append(m)
    return torch.tensor(np.stack(mats), dtype=torch.float32, device=device)


def render_step(model, cfg, dev):
    """The bench step: render, loss sum(rgb^2) + sum(mask^2), grads
    w.r.t. ws and the pose matrices. Returns step() -> (loss, d ws, d pose)."""
    pose0 = bench_poses(BATCH, dev)
    focal = torch.full((BATCH,), 1.2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    ws0 = torch.randn((BATCH, model.num_ws, model.w_dim), generator=gen,
                      device=dev) * 0.1

    def step():
        ws = ws0.clone().requires_grad_(True)
        pose = pose0.clone().requires_grad_(True)
        out, _ = render(cfg, model, pose, focal, ws, device=dev)
        loss = torch.sum(out.rgb ** 2) + torch.sum(out.mask ** 2)
        return (loss,) + torch.autograd.grad(loss, (ws, pose))

    return step


@contextlib.contextmanager
def recorded_splat_calls(limit=None):
    """Records the plane-gradient kernel calls made inside the block:
    yields a list that receives the arguments (coords3, g, H, W,
    img_shape, block_shape) of each splat3_backward call, tensors cloned,
    in the order autograd made them; with `limit`, of the first `limit`
    calls only."""
    calls = []
    original = splat.splat3_backward

    def record(coords3, g, H, W, *grid):
        if limit is None or len(calls) < limit:
            calls.append((coords3.clone(), g.clone(), H, W) + grid)
        return original(coords3, g, H, W, *grid)

    # The wrapper counts its launches on the module's splat3_backward.
    record.launches = original.launches
    splat.splat3_backward = record
    try:
        yield calls
    finally:
        splat.splat3_backward = original
        original.launches = record.launches


def splat_calls(model, cfg, dev):
    """The plane-gradient kernel calls of one bench render step (see
    recorded_splat_calls)."""
    with recorded_splat_calls() as calls:
        render_step(model, cfg, dev)()
    return calls


def inversion_case(model, cfg, dev, steps, loss="mse", lpips=None):
    """An inversion of `steps` steps with `loss` ('vgg' takes an LPIPS
    module) from the average w and a perturbed bench pose, towards the
    render of a random latent at the true pose. Returns (invert, z0, pose
    params, the target's render output)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    inv_cfg = InversionConfig(steps=steps, loss=loss)
    pose = bench_poses(BATCH, dev)
    focal = torch.full((BATCH,), 1.2, device=dev)
    with torch.no_grad():
        z_true = torch.randn((BATCH, model.latent_dim), generator=gen, device=dev)
        target, _ = render(cfg, model, pose, focal, z_true, device=dev)
        w_avg = model.average_w(generator=gen)
    z0 = (w_avg[:, :1] / inv_cfg.lr_gain_z).expand(BATCH, 1, -1).contiguous()
    p = pose_params_from_matrix(pose, focal, inv_cfg.camera_flipped)
    noise = torch.randn((BATCH, 6), generator=gen, device=dev)
    p = p._replace(q=p.q + 0.03 * noise[:, :4], t2=p.t2 + 0.02 * noise[:, 4:])
    invert = make_invert_fn(inv_cfg, cfg, model, lpips=lpips, device=dev)
    return invert, z0, p, target


GAN_BATCH = 8


def gan_case(dev, batch=GAN_BATCH, res=RES, model=None, disc=None, max_images=64):
    """One G step and one D step of the train-synthetic cell, as the
    training driver runs them: returns step() -> (G metrics, D metrics).
    Each call takes the next two iterations, with their batches and
    random draws."""
    from nerf_from_image_tpu_torch.data.loaders import load_dataset
    from nerf_from_image_tpu_torch.data.splits import StepIndexedSampler
    from nerf_from_image_tpu_torch.engine import gan
    from nerf_from_image_tpu_torch.models.discriminator import Discriminator
    from nerf_from_image_tpu_torch.train import seeded_generator

    config_ds, split, _, _ = load_dataset("synthetic", "unused", resolution=res,
                                          augment_p=0.0, max_images=max_images)
    if model is None:
        model = Generator(latent_dim=512, scene_range=config_ds.scene_range,
                          attention_values=10, use_sdf=True, device=dev,
                          generator=torch.Generator().manual_seed(1234))
    if disc is None:
        disc = Discriminator(res, 3, config_ds.camera_flipped, device=dev,
                             generator=torch.Generator().manual_seed(1235))
    config = gan.GANTrainConfig(batch_size=batch, latent_dim=model.latent_dim,
                                white_background=config_ds.white_background)
    cfg = RenderConfig(resolution=res, depth_samples_per_ray=SAMPLES,
                       scene_range=config_ds.scene_range,
                       white_background=config_ds.white_background, plane_splat=True)
    state = gan.init_gan_state(config, model, disc)
    sampler = StepIndexedSampler(len(split), seed=1234)

    def host_batch(draw, with_images):
        sel = split.select(sampler(draw, batch))
        out = {"pose": torch.as_tensor(sel.tform_cam2world, dtype=torch.float32).to(dev),
               "focal": torch.as_tensor(sel.focal_length, dtype=torch.float32).to(dev)}
        if with_images:
            out["images"] = torch.as_tensor(sel.images[..., :3], dtype=torch.float32).to(dev)
        return out

    def step():
        i = state.iteration
        gm = gan.g_step(config, cfg, state, host_batch(4 * i, False),
                        seeded_generator(dev, 1234, i))
        i = state.iteration
        dm = gan.d_step(config, cfg, state, host_batch(4 * i, True),
                        host_batch(4 * i + 1, False), seeded_generator(dev, 1234, i))
        return gm, dm

    return step


def _where(path: str, lineno: int):
    """('file:line', whether the file lies in the package); a path in the
    package is given relative to it."""
    path = os.path.abspath(path)
    inside = path.startswith(PKG_DIR + os.sep)
    return f"{os.path.relpath(path, PKG_DIR) if inside else path}:{lineno}", inside


def _call_site(filename: str, lineno: int) -> str:
    """Where a warning raised at filename:lineno was called from: that
    location if it lies in the package, else the innermost frame of the
    package on the stack followed by the location (torch's own Python
    code, say), else the location alone."""
    here, inside = _where(filename, lineno)
    if inside:
        return here
    for frame in reversed(traceback.extract_stack()):
        site, ours = _where(frame.filename, frame.lineno)
        if ours and frame.name not in ("_call_site", "record"):
            return f"{site} ({here})"
    return here


@contextlib.contextmanager
def counted_syncs():
    """Counts the synchronizing-call warnings raised inside the block by
    call site (`_call_site`): yields a Counter that fills as they come.
    Other warnings are shown as usual. The caller turns the warnings on
    (torch.cuda.set_sync_debug_mode("warn")); calls on autograd's device
    thread that no Python frame made come at the backward's call."""
    sites = collections.Counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        show = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                sites[_call_site(filename, lineno)] += 1
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = record
        yield sites


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def timeline(events, window: str):
    """From a profiler session's events: the microseconds of the host range
    named `window`, the device-busy microseconds inside it (the union of
    the device's activities, the ranges' device copies left out), and for
    each other
    range of the port (name without its prefix) [host us, idle us of the
    device gaps that began while it was the innermost range the host was
    in]; gaps in no range come under 'outside ranges'."""
    lo = hi = None
    device, ranges = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        on_device = str(e.device_type).endswith("CUDA")
        if e.name.startswith(trace.PREFIX):
            if on_device:
                continue
            if e.name == trace.PREFIX + window:
                lo, hi = start, end
            else:
                ranges.append((start, end, e.name[len(trace.PREFIX):]))
        elif on_device:
            device.append((start, end))
    busy = [(max(a, lo), min(b, hi)) for a, b in device if min(b, hi) > max(a, lo)]
    table = {name: [_union_us([(a, b) for a, b, n in ranges if n == name]), 0.0]
             for name in sorted({n for _, _, n in ranges})}
    t = lo
    for a, b in sorted(busy) + [(hi, hi)]:
        if a > t:
            inside = [(end - start, n) for start, end, n in ranges if start <= t < end]
            key = min(inside)[1] if inside else "outside ranges"
            table.setdefault(key, [0.0, 0.0])[1] += a - t
        t = max(t, b)
    return hi - lo, _union_us(busy), table


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plane_dtype", default=None, choices=(None, "bfloat16"))
    parser.add_argument("--step", default="render", choices=("render", "inversion", "gan"))
    parser.add_argument("--loss", default="mse", choices=("mse", "vgg"))
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--count_syncs", action="store_true",
                        help="count one warm step's synchronizing calls by call site "
                             "instead of profiling")

    args = parser.parse_args(argv)

    dev = resolve_device("cuda")
    set_strict_f32()

    if args.step == "gan":
        if args.plane_dtype is not None:
            parser.error("--step gan runs the cell's f32 planes")
        step = gan_case(dev)
    else:
        model = Generator(latent_dim=512, scene_range=1.4, attention_values=10,
                          use_sdf=True, device=dev,
                          generator=torch.Generator().manual_seed(0))
        model.requires_grad_(False)
        cfg = RenderConfig(resolution=RES, depth_samples_per_ray=SAMPLES,
                           scene_range=1.4, plane_dtype=args.plane_dtype,
                           query_chunk=None, plane_splat=True)
    if args.step == "render":
        step = render_step(model, cfg, dev)
    elif args.step == "inversion":
        lpips = LPIPS(torch.Generator().manual_seed(4), device=dev) \
            if args.loss == "vgg" else None
        invert, z0, pose, target = inversion_case(model, cfg, dev, steps=1,
                                                  loss=args.loss, lpips=lpips)
        step = lambda: invert(z0, pose, target.rgb)  # noqa: E731

    step()
    torch.cuda.synchronize()
    label = {"render": "render", "gan": "gan (one G step + one D step, B=8)"}.get(
        args.step, f"inversion loss={args.loss}")
    if args.count_syncs:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with counted_syncs() as sites:
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"{label}: synchronizing calls in one warm step, by call site:")
        for site, n in sites.most_common():
            print(f"{n:6d}  {site}")
        print(json.dumps({"step": args.step,
                          "loss": args.loss if args.step == "inversion" else None,
                          "sync_calls": sum(sites.values()), "by_site": dict(sites),
                          "device": torch.cuda.get_device_name(0)}))
        return
    steps = 2
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("profile_step"):
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    # Device rows (kernels, memsets) only: operator rows repeat the time
    # of the kernels they launch, and a range's device row is no work.
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and not e.key.startswith(trace.PREFIX)]
    window_us, busy_us, ranges = timeline(prof.events(), "profile_step")
    print(f"{label} plane_dtype={args.plane_dtype or 'float32'}: wall {wall_us / steps / 1e3:.1f} "
          f"ms/step, device busy {busy_us / steps / 1e3:.1f} ms/step "
          f"({100 * busy_us / window_us:.1f}% of wall)")
    for e in kernels[: args.top]:
        print(f"{_device_us(e) / steps / 1e3:9.3f} ms/step  x{e.count // steps:<5d} "
              f"{e.key[:110]}")
    ops = [e for e in events if e.key.startswith("aten::")][: args.top // 2]
    print("operators (self device time):")
    for e in ops:
        print(f"{_device_us(e) / steps / 1e3:9.3f} ms/step  x{e.count // steps:<5d} {e.key}")
    print("ranges (host ms/step, device idle ms/step of the gaps that began in it):")
    for name, (host_us, idle_us) in sorted(ranges.items(), key=lambda kv: -kv[1][1]):
        print(f"{host_us / steps / 1e3:9.3f} {idle_us / steps / 1e3:9.3f}  {name}")
    print(json.dumps({
        "step": args.step,
        "loss": args.loss if args.step == "inversion" else None,
        "batch": GAN_BATCH if args.step == "gan" else BATCH,
        "plane_dtype": args.plane_dtype or "float32",
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / window_us,
        "idle_ms_per_step_by_range": {k: v[1] / steps / 1e3 for k, v in ranges.items()},
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
