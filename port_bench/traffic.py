"""The one generator of the benchmark's inputs: images and cameras drawn
on the device from the seed, by the parameters of a traffic file
(`port_bench/traffic/<name>.json`).

Cameras orbit the scene's centre: azimuth uniform, elevation uniform in
`elevation`, distance uniform in `distance`, focal (in units of half the
image) uniform in `focal`, looking at the origin with z up (the in-repo
synthetic dataset's orbit, `flipped` for datasets whose camera looks down
+z). Images are an object over a plain background: an ellipse of random
centre, radii and angle, filled with smooth random colour (bilinear
upsampling of a coarse grid of `color_cells`^2 colours), with the
object's mask as a fourth channel, in [-1, 1].
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _uniform(gen, n, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def cameras(gen: torch.Generator, n: int, spec: Dict, device) -> Dict[str, torch.Tensor]:
    """n cameras: {'pose': [n, 4, 4] camera-to-world, 'focal': [n]}."""
    theta = _uniform(gen, n, (0.0, 2 * math.pi), device)
    phi = _uniform(gen, n, spec["elevation"], device)
    radius = _uniform(gen, n, spec["distance"], device)
    focal = _uniform(gen, n, spec["focal"], device)
    eye = radius[:, None] * torch.stack(
        (torch.cos(phi) * torch.cos(theta), torch.cos(phi) * torch.sin(theta), torch.sin(phi)),
        dim=-1)
    forward = -eye / torch.linalg.vector_norm(eye, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=device).expand_as(forward)
    right = torch.linalg.cross(forward, up)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    up = torch.linalg.cross(right, forward)
    pose = torch.eye(4, device=device).repeat(n, 1, 1)
    pose[:, :3, 0] = right
    pose[:, :3, 1] = up
    pose[:, :3, 2] = -forward
    pose[:, :3, 3] = eye
    if spec.get("flipped", False):
        pose[:, :3, 1:3] *= -1
    return {"pose": pose, "focal": focal}


def images(gen: torch.Generator, n: int, resolution: int, spec: Dict, device) -> torch.Tensor:
    """n images [n, R, R, 4]: RGB in [-1, 1] and the mask in {0, 1}."""
    r = resolution
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, r, device=device),
                            torch.linspace(-1, 1, r, device=device), indexing="ij")
    cx = _uniform(gen, n, spec["center"], device)[:, None, None]
    cy = _uniform(gen, n, spec["center"], device)[:, None, None]
    ra = _uniform(gen, n, spec["radius"], device)[:, None, None]
    rb = _uniform(gen, n, spec["radius"], device)[:, None, None]
    angle = _uniform(gen, n, (0.0, math.pi), device)[:, None, None]
    u = (xx - cx) * torch.cos(angle) + (yy - cy) * torch.sin(angle)
    v = -(xx - cx) * torch.sin(angle) + (yy - cy) * torch.cos(angle)
    mask = ((u / ra) ** 2 + (v / rb) ** 2 < 1.0).float()
    cells = spec["color_cells"]
    coarse = torch.rand((n, 3, cells, cells), generator=gen, device=device) * 2 - 1
    color = torch.nn.functional.interpolate(coarse, size=(r, r), mode="bilinear",
                                            align_corners=True).permute(0, 2, 3, 1)
    background = torch.full_like(color, float(spec["background"]))
    rgb = background * (1 - mask[..., None]) + color * mask[..., None]
    return torch.cat((rgb, mask[..., None]), dim=-1)
