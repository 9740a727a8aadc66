"""Separable StyleGAN2 resampling filters (NCHW) and the GAN warm-up blur
(NHWC images).

Counterpart of nerf_from_image_tpu/ops/filters.py. The JAX package
emulates torch's conv_transpose2d semantics for `transpose=True`; here
that is torch's own op. The blurs run in strict f32 (TF32 off on the
card, utils/device.py::set_strict_f32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.ops import conv as conv_ops


def bilinear_filter(dtype=torch.float32, device=None) -> torch.Tensor:
    """The normalized separable [1, 3, 3, 1] resampling filter [4, 4]."""
    h = np.array([1.0, 3.0, 3.0, 1.0])
    h = h[:, None] * h[None, :]
    h /= h.sum()
    return torch.as_tensor(h, dtype=dtype, device=device)


def depthwise_conv2d(x, kernel2d, stride=1, padding=0, transpose=False):
    """The same 2D kernel on every channel of an NCHW tensor;
    `transpose=True` is conv_transpose2d (stride dilates the input).

    The channels are folded into the batch and filtered by one
    single-channel convolution, not a grouped one (autograd's double
    backward of a grouped convolution loops over the groups, one
    convolution each), through ops/conv.py (whose double backward does
    not compute the constant filter's gradient)."""
    B, C, H, W = x.shape
    weight = kernel2d.to(x.dtype)[None, None]
    conv = conv_ops.conv_transpose2d if transpose else conv_ops.conv2d
    y = conv(x.reshape(B * C, 1, H, W), weight, stride, padding)
    return y.reshape(B, C, y.shape[-2], y.shape[-1])


def filter2d(x, kernel2d, gain: float = 1.0, transpose: bool = False):
    """4-tap low-pass filtering with padding 1 (shrinks/grows H, W by 1)."""
    if gain != 1.0:
        kernel2d = kernel2d * gain
    return depthwise_conv2d(x, kernel2d, stride=1, padding=1, transpose=transpose)


def upsample2d(x, kernel2d):
    """2x upsampling: strided transposed depthwise conv with 4x gain."""
    return depthwise_conv2d(x, kernel2d * 4.0, stride=2, padding=1, transpose=True)


def downsample2d(x, kernel2d):
    """2x downsampling: strided depthwise conv."""
    return depthwise_conv2d(x, kernel2d, stride=2, padding=1)


def blur_dynamic(x: torch.Tensor, sigma: float, white_background: bool,
                 max_blur_size: int = 30) -> torch.Tensor:
    """The discriminator-input warm-up blur of NHWC images at any sigma,
    through one fixed 2 * max_blur_size + 1 tap support.

    Taps beyond floor(3 sigma) are masked to zero, so the kernel equals
    the reference's floor(3 sigma)-tap kernel, with sigma in f32 as the
    JAX package traces it (the JAX package's static `blur` takes it in
    f64: they can differ by one tap within one ulp of a kernel-size
    boundary). At floor(3 sigma) = 0 it is the identity. The kernel is the
    outer product of the 1D taps, applied as a row and a column pass on
    the channels folded into the batch, as in depthwise_conv2d. With a
    white background the blur runs on x - 1, so that the zero padding is
    white.
    """
    sigma = np.float32(sigma)
    blur_size = np.floor(sigma * np.float32(3.0))
    if blur_size <= 0:
        return x
    taps = torch.arange(-max_blur_size, max_blur_size + 1, dtype=x.dtype, device=x.device)
    f = torch.exp2(-torch.square(taps / float(sigma)))
    f = torch.where(torch.abs(taps) <= float(blur_size), f, torch.zeros_like(f))
    taps = f / torch.sum(f)
    if white_background:
        x = x - 1.0
    B, H, W, C = x.shape
    K = taps.shape[0]
    y = x.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    y = F.conv2d(y, taps.reshape(1, 1, 1, K), padding=(0, K // 2))
    y = F.conv2d(y, taps.reshape(1, 1, K, 1), padding=(K // 2, 0))
    y = y.reshape(B, C, H, W).permute(0, 2, 3, 1)
    if white_background:
        y = y + 1.0
    return y


def blur_schedule_sigma(iteration, blur_warmup_iters: int) -> float:
    """Progressive blur sigma: 10 -> 0 linearly over the warm-up, in f32
    as the JAX package traces it."""
    frac = np.float32(iteration) / np.float32(blur_warmup_iters)
    return float(np.maximum(np.float32(1.0) - frac, np.float32(0.0)) * np.float32(10.0))
