"""Equalized-learning-rate layers and StyleGAN2 modulated convolution.

Counterpart of nerf_from_image_tpu/models/layers.py. Convolutions run NCHW
with torch-layout weights (OIHW convs, [out, in] linears), the layouts the
JAX package stores, so weights carry over without re-layout.

Parameters are created uninitialized; Generator initializes them all
from one torch.Generator (models/generator.py::init_parameters).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_from_image_tpu_torch.ops import conv as conv_ops
from nerf_from_image_tpu_torch.ops import filters


def leaky_relu(x, slope: float = 0.2):
    return torch.where(x >= 0, x, x * slope)


class EqualizedLinear(nn.Module):
    """Linear layer with runtime weight scaling (equalized learning rate).

    `forward(x, dtype=None)`: a dtype (bf16 in the bf16-table render mode)
    runs the matmul and bias in it; parameters stay f32.
    """

    def __init__(self, in_features, out_features, use_bias=True, activate=False,
                 lr_multiplier=1.0, init_bias_one=False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.activate = activate
        self.lr_multiplier = lr_multiplier
        self.init_bias_one = init_bias_one
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (
            nn.Parameter(torch.empty(out_features)) if use_bias else None
        )

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(self.lr_multiplier)
            if self.bias is not None:
                self.bias.fill_(1.0 if self.init_bias_one else 0.0)

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        weight_gain = self.lr_multiplier / math.sqrt(self.in_features)
        scaled = self.weight * weight_gain
        if dtype is not None:
            x = x.to(dtype)
            scaled = scaled.to(dtype)
        y = x @ scaled.T
        if self.bias is not None:
            bias = self.bias * self.lr_multiplier
            if dtype is not None:
                bias = bias.to(dtype)
            y = y + bias
        if self.activate:
            y = leaky_relu(y * math.sqrt(2.0))
        return y


def conv2d(x, weight_oihw, stride=1, padding=0):
    return conv_ops.conv2d(x, weight_oihw, stride, padding)


def conv_transpose2d(x, weight_iohw, stride=2, padding=0):
    return conv_ops.conv_transpose2d(x, weight_iohw, stride, padding)


def conv_resampled2d(x, weight_oihw, f=None, up=False, down=False, padding=0):
    """Conv fused with 2x up/down resampling (reference:
    models/stylegan.py:86-111)."""
    assert not (up and down)
    kw = weight_oihw.shape[-1]
    if kw == 1 and down:
        assert padding == 0
        x = filters.downsample2d(x, f)
        return conv2d(x, weight_oihw)
    if down:
        x = filters.filter2d(x, f, transpose=True)
        return conv2d(x, weight_oihw, stride=2)
    if up:
        assert padding == 1
        x = conv_transpose2d(x, weight_oihw.transpose(0, 1), stride=2)
        return filters.filter2d(x, f, gain=4.0)
    return conv2d(x, weight_oihw, padding=padding)


def conv_modulated2d(x, weight_oihw, styles, noise=None, up=False, down=False,
                     padding=0, resample_filter=None, demodulate=True):
    """StyleGAN2 modulated convolution (input-scale / output-demodulate).

    x: [B, Cin, H, W]; weight_oihw: [Cout, Cin, kh, kw]; styles: [B, Cin];
    noise: optional [B or 1, 1, H', W'] (already scaled).
    """
    bs = x.shape[0]
    if demodulate:
        w = weight_oihw[None] * styles.reshape(bs, 1, -1, 1, 1)
        dcoefs = torch.rsqrt(torch.sum(torch.square(w), dim=(2, 3, 4)) + 1e-8)
    x = x * styles.reshape(bs, -1, 1, 1)
    x = conv_resampled2d(
        x, weight_oihw, f=resample_filter, up=up, down=down, padding=padding
    )
    if demodulate:
        x = x * dcoefs.reshape(bs, -1, 1, 1)
    if noise is not None:
        x = x + noise
    return x


class EqualizedConv2d(nn.Module):
    """Equalized-lr conv with optional fused 2x resampling and activation."""

    def __init__(self, in_channels, out_channels, kernel_size, use_bias=True,
                 activate=False, up=False, down=False):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.activate = activate
        self.up = up
        self.down = down
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, gain: float = 1.0):
        weight_gain = 1.0 / math.sqrt(self.in_channels * self.kernel_size**2)
        x = conv_resampled2d(
            x,
            self.weight * weight_gain,
            f=filters.bilinear_filter(x.dtype, x.device),
            up=self.up,
            down=self.down,
            padding=self.kernel_size // 2,
        )
        act_gain = (math.sqrt(2.0) if self.activate else 1.0) * gain
        if self.bias is not None:
            x = x + self.bias.reshape(1, -1, 1, 1)
        if act_gain != 1.0:
            x = x * act_gain
        if self.activate:
            x = leaky_relu(x)
        return x


def normalize_latent(x, dim=-1, eps=1e-8):
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)


class LayerNormAffine(nn.Module):
    """Plain LayerNorm over the last axis with a learnable affine (torch
    names weight/bias; population variance, eps 1e-5)."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class ConditionalLayerNorm(nn.Module):
    """LayerNorm modulated by a latent (reference: models/generator.py:42-60)."""

    def __init__(self, ch, emb_dim):
        super().__init__()
        self.fc_beta = EqualizedLinear(emb_dim, ch)
        self.fc_gamma = EqualizedLinear(emb_dim, ch)

    def forward(self, x, z):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        x = (x - mean) * torch.rsqrt(var + 1e-5)
        beta = self.fc_beta(z)
        gamma = self.fc_gamma(z)
        while beta.dim() < x.dim():
            beta = beta[..., None, :]
            gamma = gamma[..., None, :]
        return beta + (1.0 + gamma) * x
