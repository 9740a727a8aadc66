"""The least time of the plane-gradient kernel (K1): the [B, 3, H, W, C]
f32 gradient of the 3-plane bilinear mean of B x N points, from its
inputs read once (the points' coordinates, f32 [B, N, 3], and their
gradients, f32 [B, N, C]) and its output written once, at the card's
memory rate, or the operations it needs (4 corners x 3 planes x C
multiply-adds a point) at the f32 rate, whichever is longer. The
program's profile_splat and chip_smoke count it so: at B=4 and the
coarse points of a 128^2 x 64 render on 256^2 x 32 planes it is 0.205 ms,
bound by bytes.
"""

from __future__ import annotations

import json
import os
from typing import Dict

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def bound_ms(batch: int, points: int, height: int, width: int, channels: int) -> float:
    with open(PEAKS) as f:
        peaks = json.load(f)
    n_bytes = 4 * (batch * points * 3 + batch * points * channels
                   + 3 * batch * height * width * channels)
    n_ops = batch * points * 3 * 4 * channels * 2
    return max(n_bytes / peaks["bytes_per_s"], n_ops / peaks["flops"]["float32"]) * 1e3


def render_bound_ms(config: Dict) -> float:
    """The bound of one render's backward: a launch per pass (coarse and
    fine) and per chunk of `query_chunk` points of each batch element."""
    r, g = config["render"], config["generator"]
    points = r["resolution"] ** 2 * r["depth_samples_per_ray"]
    chunk = r["query_chunk"]
    launches, per = (points // chunk, chunk) if chunk and points > chunk else (1, points)
    passes = 2 if r["fine_sampling"] else 1
    plane = g["synthesis_resolution"]
    return passes * launches * bound_ms(config["batch_size"], per, plane, plane,
                                        g["plane_channels"])
