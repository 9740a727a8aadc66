"""The port's headline benchmark: render forward+backward rays/s on one card.

    python -m nerf_from_image_tpu_torch.bench [--plane_dtype float32]

Counterpart of bench.py:58-127: the fully differentiable render of the
bench model (Generator(latent_dim=512, scene_range=1.4,
attention_values=10, use_sdf=True), random weights from a seed), B=4,
128^2 rays, 64 coarse + 64 fine samples, `plane_splat`, unchunked, with
gradients w.r.t. the latents and the camera pose
(profile_step.render_step). Planes are gathered in bf16 as in bench.py:83;
`--plane_dtype float32` is the strict-f32 parity configuration. There is
no fallback configuration: a failure raises.

Prints one JSON line {"metric", "value", "unit", "vs_baseline"}: rays per
second from the median of ITERS steps after one warm-up step, each
step timed on the host clock up to torch.cuda.synchronize() (time_steps,
which chip_smoke.py's render phase uses too). `vs_baseline` is against the
port's first bf16 reading, 186.2 ms a step on an NVIDIA H100 80GB HBM3 at
700 W.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from nerf_from_image_tpu_torch.engine.render import RenderConfig
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.profile_step import BATCH, RES, SAMPLES, render_step
from nerf_from_image_tpu_torch.utils.device import resolve_device, set_strict_f32

METRIC = "raymarch_fwdbwd_rays_per_s_per_chip"
BASELINE_MS_PER_STEP = 186.2  # the port's first bf16 reading on the card
ITERS = 8


def bench_config(plane_dtype="bfloat16") -> RenderConfig:
    """bench.py's render configuration; plane_dtype 'float32' gathers f32."""
    return RenderConfig(
        resolution=RES, depth_samples_per_ray=SAMPLES, fine_sampling=True,
        scene_range=1.4, white_background=False,
        plane_dtype=None if plane_dtype == "float32" else plane_dtype,
        query_chunk=None, plane_splat=True, splat_block=(16, 16, 4),
        merge_mode="pairwise",
    )


def time_steps(step, iters: int, device) -> List[float]:
    """ms of each of `iters` calls of step(), each timed alone on the host
    clock up to a device synchronize."""
    dev = torch.device(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def result(times_ms: List[float], batch: int, resolution: int) -> dict:
    """The JSON line of the median step."""
    rays_per_s = batch * resolution * resolution / (float(np.median(times_ms)) / 1e3)
    baseline = BATCH * RES * RES / (BASELINE_MS_PER_STEP / 1e3)
    return {"metric": METRIC, "value": round(rays_per_s, 1), "unit": "rays/s",
            "vs_baseline": round(rays_per_s / baseline, 3)}


def run(model, cfg: RenderConfig, device, iters: int = ITERS):
    """One warm-up step, then `iters` timed steps of the bench step.
    Returns (the JSON line's dict, the last step's (loss, d ws, d pose))."""
    step = render_step(model, cfg, device)
    out = step()
    for name, t in zip(("loss", "d ws", "d pose"), out):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"bench: non-finite {name}")
    last = []

    def timed():
        last[:] = step()

    times = time_steps(timed, iters, device)
    return result(times, BATCH, cfg.resolution), tuple(last)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plane_dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    set_strict_f32()
    model = Generator(latent_dim=512, scene_range=1.4, attention_values=10,
                      use_sdf=True, device=dev,
                      generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    line, _ = run(model, bench_config(args.plane_dtype), dev)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
