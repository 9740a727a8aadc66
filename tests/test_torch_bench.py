"""The port's bench (nerf_from_image_tpu_torch/bench.py) at a tiny width on
the CPU: its step gives finite gradients w.r.t. the latents and the pose,
and it reports one JSON line with bench.py's four keys."""

import dataclasses
import json

import numpy as np
import torch

from nerf_from_image_tpu_torch import bench
from nerf_from_image_tpu_torch.models.generator import Generator
from tests.test_torch_generator import release_memory  # noqa: F401


def test_bench_step_runs_on_the_cpu_and_reports_one_json_line():
    model = Generator(latent_dim=8, scene_range=1.4, attention_values=4, use_sdf=True,
                      w_dim=8, plane_channels=32, synthesis_resolution=8,
                      channel_base=64, channel_max=8, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    cfg = dataclasses.replace(bench.bench_config("float32"), resolution=16,
                              depth_samples_per_ray=4)
    assert cfg.plane_splat and cfg.query_chunk is None and cfg.fine_sampling
    assert bench.bench_config().plane_dtype == "bfloat16"
    line, (loss, d_ws, d_pose) = bench.run(model, cfg, "cpu", iters=2)
    assert d_ws.shape == (bench.BATCH, model.num_ws, 8) and d_pose.shape == (bench.BATCH, 4, 4)
    for t in (loss, d_ws, d_pose):
        assert torch.isfinite(t).all()
    assert float(d_ws.abs().sum()) > 0 and float(d_pose.abs().sum()) > 0
    parsed = json.loads(json.dumps(line))
    assert sorted(parsed) == ["metric", "unit", "value", "vs_baseline"]
    assert parsed["unit"] == "rays/s" and parsed["value"] > 0
    baseline = bench.BATCH * 128 * 128 / (bench.BASELINE_MS_PER_STEP / 1e3)
    np.testing.assert_allclose(parsed["vs_baseline"], parsed["value"] / baseline, atol=1e-3)
