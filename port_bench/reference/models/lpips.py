"""LPIPS perceptual distance with a VGG16 trunk.

Counterpart of nerf_from_image_tpu/models/lpips.py. The public API is
NHWC, as there: images [B, H, W, 3] in [-1, 1], and `features` returns
the five normalized tap activations [B, h, w, c]. The convolutions run on
the NHWC memory as channels-last NCHW tensors, so no layout copy is made.

`features` lets the inversion compute the target's features once and
reuse them at every step; `distance_from_features` takes two feature
tuples. Weights come from an explicit torch.Generator (He-style random
features, not metric grade) or from an `lpips`-package VGG16 state dict
(`lpips_state_to_state_dict` in utils/weights.py) named by
NFI_LPIPS_WEIGHTS; nothing is downloaded.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv plan: (out_channels, convs) per stage; LPIPS taps the relu
# output at the end of each stage.
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Features = Tuple[torch.Tensor, ...]


def _conv_shapes():
    """(in_channels, out_channels) of the 13 convolutions in order."""
    shapes, cin = [], 3
    for ch, n in VGG_STAGES:
        for _ in range(n):
            shapes.append((cin, ch))
            cin = ch
    return shapes


class VGG16Features(nn.Module):
    """VGG16 trunk emitting the 5 LPIPS tap activations (NCHW in, NCHW
    out; channels-last memory in, channels-last memory out)."""

    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.convs = nn.ModuleList()
        for cin, cout in _conv_shapes():
            conv = nn.Conv2d(cin, cout, 3, padding=1, device=device)
            with torch.no_grad():
                # He-normal kernels and zero biases: deterministic random
                # features from the generator.
                w = torch.randn(conv.weight.shape, generator=generator)
                conv.weight.copy_(w * (2.0 / (cin * 9)) ** 0.5)
                conv.bias.zero_()
            self.convs.append(conv)

    def forward(self, x: torch.Tensor) -> Features:
        taps = []
        convs = iter(self.convs)
        for stage, (_, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                x = F.relu(next(convs)(x))
            taps.append(x)
            if stage < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return tuple(taps)


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalizes along the last (channel) axis (lpips.normalize_tensor)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """Perceptual distance: the sum over taps of the spatial mean of
    lin_l(|f0 - f1|^2). A fixed metric: its weights take no gradient."""

    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.net = VGG16Features(generator, device)
        lins = []
        for ch, _ in VGG_STAGES:
            lins.append(nn.Parameter(
                torch.rand((ch,), generator=generator).to(device) * 0.1))
        self.lins = nn.ParameterList(lins)
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device),
                             persistent=False)
        self.requires_grad_(False)

    def features(self, im: torch.Tensor) -> Features:
        """im [B, H, W, 3] in [-1, 1] -> the normalized taps, NHWC."""
        x = ((im - self.shift) / self.scale).permute(0, 3, 1, 2)
        return tuple(normalize_tensor(t.permute(0, 2, 3, 1)) for t in self.net(x))

    def distance_from_features(self, f0: Sequence[torch.Tensor],
                               f1: Sequence[torch.Tensor]) -> torch.Tensor:
        """[B, 1] distance between two feature tuples (1x1 heads clamped
        non-negative, as lpips does at eval)."""
        total = 0.0
        for lin, x, y in zip(self.lins, f0, f1):
            d = torch.square(x - y) @ torch.clamp_min(lin, 0.0)
            total = total + torch.mean(d, dim=(1, 2))
        return total[:, None]

    def forward(self, in0: torch.Tensor, in1) -> torch.Tensor:
        """Distance between images in0 and in1 (images or cached features)."""
        f1 = in1 if isinstance(in1, tuple) else self.features(in1)
        return self.distance_from_features(self.features(in0), f1)
