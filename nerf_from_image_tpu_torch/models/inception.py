"""FID InceptionV3 (the "TensorFlow weights" variant) as a torch module.

Counterpart of nerf_from_image_tpu/models/inception.py, which rebuilds
pytorch-fid's FID Inception: the InceptionA/C/E_1 blocks average-pool with
count_include_pad=False, and InceptionE_2 max-pools (3x3, stride 1, pad 1)
in its pool branch. Module and parameter names are pytorch-fid's
(`Conv2d_1a_3x3.conv.weight`, `Mixed_7c.branch_pool.bn.running_var`, ...),
so its released `pt_inception` state dict loads strictly once `fc.*`,
`AuxLogits.*` and `num_batches_tracked` are dropped
(utils/weights.py::load_inception_weights).

Inputs are NHWC in [0, 1], the JAX package's contract. They are resized
to 299x299 as jax.image.resize(..., 'bilinear') does (a triangle filter
with half-pixel centers, widened to antialias when it shrinks), scaled to
[-1, 1], and the pool3 features averaged over H and W give 2048
activations. The network runs in inference mode only: batch norm uses its
running statistics with eps 1e-3.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_from_image_tpu_torch.utils.device import resolve_device

SIZE = 299


class _BatchNorm(nn.Module):
    """Inference batch norm (eps 1e-3) with pytorch-fid's parameter and
    buffer names and no `num_batches_tracked`."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=1e-3)


class BasicConv2d(nn.Module):
    """Conv (no bias) + batch norm + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = _BatchNorm(out_channels)

    def init_parameters(self, generator: torch.Generator):
        """He-normal weights (std sqrt(2 / fan_in)); identity batch norm."""
        fan_in = self.conv.weight[0].numel()
        with torch.no_grad():
            self.conv.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """E_1 (pool_mode 'avg', count_include_pad=False) or E_2 ('max')."""

    def __init__(self, in_ch: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_mode == "avg":
            bp = _avg_pool(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] weights of jax.image.resize's 'bilinear' along
    one axis: a triangle kernel at half-pixel centers, widened by
    in_size / out_size when shrinking (antialiasing), each row normalized
    to sum 1."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], weights, 0.0).astype(np.float32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW resize to `size` as jax.image.resize(..., 'bilinear'): the rows,
    then the columns, each a contraction with resize_weights."""
    h, w = x.shape[-2:]
    wh = torch.as_tensor(resize_weights(h, size[0]), device=x.device, dtype=x.dtype)
    ww = torch.as_tensor(resize_weights(w, size[1]), device=x.device, dtype=x.dtype)
    x = torch.einsum("oh,nchw->ncow", wh, x)
    return torch.einsum("pw,ncow->ncop", ww, x)


class FIDInceptionV3(nn.Module):
    """x [B, H, W, 3] in [0, 1] -> pool3 activations [B, 2048].

    Parameters are drawn from `generator` (a CPU torch.Generator; None
    means seed 0: He-normal convolutions, identity batch norm) and moved
    to `device` ('cuda' by default). Load real weights with
    utils/weights.py::load_inception_weights.
    """

    def __init__(self, resize_input: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool_mode="avg")
        self.Mixed_7c = InceptionE(2048, pool_mode="max")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, BasicConv2d):
                m.init_parameters(generator)
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_bilinear(x, (SIZE, SIZE))
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))
