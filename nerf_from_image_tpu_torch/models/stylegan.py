"""StyleGAN2 backbone: mapping, synthesis and the discriminator.

Counterpart of nerf_from_image_tpu/models/stylegan.py. Attribute names are
the reference state-dict keys (fc0..fcN, b4..b256, conv0/conv1/torgb,
affine, fromrgb/skip, ...). Activations run NCHW inside; SynthesisNetwork
returns NHWC and DiscriminatorBackbone takes NHWC, like the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from nerf_from_image_tpu_torch.models.layers import (
    EqualizedConv2d,
    EqualizedLinear,
    conv_modulated2d,
    leaky_relu,
    normalize_latent,
)
from nerf_from_image_tpu_torch.ops import filters


class MappingNetwork(nn.Module):
    """z (+ optional conditioning c) -> w, broadcast to num_ws.

    c_dim = 0 is the unconditional network. With c_dim > 0, c is embedded
    (`embed`, then normalized) when normalize_c, else concatenated as it
    is; z_dim = 0 maps c alone (the discriminator's projection)."""

    def __init__(self, z_dim, w_dim, num_ws: Optional[int], num_layers=8,
                 lr_multiplier=0.01, layer_features=None, c_dim=0,
                 normalize_c=True, embed_features=None):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.normalize_c = normalize_c
        self.num_ws = num_ws
        self.num_layers = num_layers
        if embed_features is None:
            embed_features = w_dim if normalize_c else c_dim
        if c_dim == 0:
            embed_features = 0
        if c_dim > 0 and normalize_c:
            self.embed = EqualizedLinear(c_dim, embed_features)
        layer_features = layer_features or w_dim
        features = ([z_dim + embed_features] + [layer_features] * (num_layers - 1)
                    + [w_dim])
        for idx in range(num_layers):
            self.add_module(
                f"fc{idx}",
                EqualizedLinear(features[idx], features[idx + 1], activate=True,
                                lr_multiplier=lr_multiplier),
            )

    def forward(self, z, c=None):
        x = normalize_latent(z) if self.z_dim > 0 else None
        if self.c_dim > 0:
            y = normalize_latent(self.embed(c)) if self.normalize_c else c
            x = torch.cat((x, y), dim=-1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        if self.num_ws is not None and x.dim() == 2:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        return x


def _noise(generator, shape, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


class SynthesisLayer(nn.Module):
    """Modulated 3x3 conv (+ optional 2x upsample) with noise and lrelu."""

    def __init__(self, in_channels, out_channels, w_dim, resolution,
                 kernel_size=3, up=False, use_noise=True, activate=True):
        super().__init__()
        self.resolution = resolution
        self.kernel_size = kernel_size
        self.up = up
        self.use_noise = use_noise
        self.activate = activate
        self.affine = EqualizedLinear(w_dim, in_channels, init_bias_one=True)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        if use_noise:
            self.noise_strength = nn.Parameter(torch.empty(()))
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            self.bias.zero_()
            if self.use_noise:
                self.noise_strength.zero_()
                self.noise_const.normal_(generator=generator)

    def forward(self, x, w, noise_mode="none", generator=None, gain=1.0):
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            shape = (x.shape[0], 1, self.resolution, self.resolution)
            noise = _noise(generator, shape, x) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, None]
        x = conv_modulated2d(
            x, self.weight, styles, noise=noise, up=self.up,
            padding=self.kernel_size // 2,
            resample_filter=filters.bilinear_filter(x.dtype, x.device),
        )
        act_gain = (math.sqrt(2.0) if self.activate else 1.0) * gain
        x = x + self.bias.reshape(1, -1, 1, 1)
        if act_gain != 1.0:
            x = x * act_gain
        if self.activate:
            x = leaky_relu(x)
        return x


class OutputLayer(nn.Module):
    """toRGB: modulated 1x1 conv without demodulation."""

    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1):
        super().__init__()
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size**2)
        self.affine = EqualizedLinear(w_dim, in_channels, init_bias_one=True)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            self.bias.zero_()

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = conv_modulated2d(x, self.weight, styles, demodulate=False)
        return x + self.bias.reshape(1, -1, 1, 1)


class SynthesisBlock(nn.Module):
    def __init__(self, in_channels, out_channels, w_dim, resolution,
                 img_channels, use_noise=True):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        if in_channels == 0:
            self.const = nn.Parameter(
                torch.empty(out_channels, resolution, resolution)
            )
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim,
                                        resolution, up=True, use_noise=use_noise)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim,
                                    resolution, use_noise=use_noise)
        self.torgb = OutputLayer(out_channels, img_channels, w_dim)

    def init_parameters(self, generator: torch.Generator):
        if self.in_channels == 0:
            with torch.no_grad():
                self.const.normal_(generator=generator)

    def forward(self, x, img, ws, noise_mode="none", generator=None):
        """x, img: NCHW (None at the first block); ws: [B, n, w_dim]."""
        w_idx = 0
        if self.in_channels == 0:
            x = self.const[None].expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x, ws[:, w_idx], noise_mode, generator)
            w_idx += 1
        x = self.conv1(x, ws[:, w_idx], noise_mode, generator)
        w_idx += 1
        if img is not None:
            img = filters.upsample2d(img, filters.bilinear_filter(img.dtype, img.device))
        y = self.torgb(x, ws[:, w_idx])
        img = img + y if img is not None else y
        return x, img


def synthesis_channel_dict(img_resolution, channel_base=32768, channel_max=512):
    resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
    return resolutions, {
        res: min(channel_base // res, channel_max) for res in resolutions
    }


class SynthesisNetwork(nn.Module):
    """Progressive const-4x4 -> img_resolution synthesis pyramid."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, use_noise=True):
        super().__init__()
        self.resolutions, channels = synthesis_channel_dict(
            img_resolution, channel_base, channel_max
        )
        for res in self.resolutions:
            in_ch = channels[res // 2] if res > 4 else 0
            self.add_module(
                f"b{res}",
                SynthesisBlock(in_ch, channels[res], w_dim, res, img_channels,
                               use_noise=use_noise),
            )

    @property
    def num_ws(self) -> int:
        # 1 conv for the 4x4 block, 2 for the rest, +1 torgb on the last.
        return sum(1 if res == 4 else 2 for res in self.resolutions) + 1

    def forward(self, ws, noise_mode: str = "none", generator=None):
        """ws [B, num_ws, w_dim] -> image NHWC [B, R, R, img_channels]."""
        x = img = None
        w_idx = 0
        for res in self.resolutions:
            num_conv = 1 if res == 4 else 2
            block_ws = ws[:, w_idx : w_idx + num_conv + 1]
            w_idx += num_conv
            x, img = getattr(self, f"b{res}")(x, img, block_ws, noise_mode,
                                              generator)
        return img.permute(0, 2, 3, 1)


class DiscriminatorBlock(nn.Module):
    """fromrgb (first block only), a 1x1 down-sampling skip and two 3x3
    convs, the second down-sampling; NCHW."""

    def __init__(self, in_channels, tmp_channels, out_channels, img_channels):
        super().__init__()
        self.in_channels = in_channels
        if in_channels == 0:
            self.fromrgb = EqualizedConv2d(img_channels, tmp_channels, 1,
                                           activate=True)
        self.skip = EqualizedConv2d(tmp_channels, out_channels, 1, use_bias=False,
                                    down=True)
        self.conv0 = EqualizedConv2d(tmp_channels, tmp_channels, 3, activate=True)
        self.conv1 = EqualizedConv2d(tmp_channels, out_channels, 3, activate=True,
                                     down=True)

    def forward(self, x, img):
        if self.in_channels == 0:
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = None
        y = self.skip(x, gain=math.sqrt(2.0) / 2.0)
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(2.0) / 2.0)
        return y + x, img


def minibatch_std(x, group_size: int, num_channels: int = 1):
    """Appends the per-group feature standard deviation as num_channels
    channels (NCHW): groups are the outer split of the batch, channels
    split into num_channels outer groups, as in the JAX package."""
    bs, c, h, w = x.shape
    ng = min(group_size, bs)
    f = num_channels
    y = x.reshape(ng, bs // ng, f, c // f, h, w)
    y = y - torch.mean(y, dim=0, keepdim=True)
    y = torch.mean(torch.square(y), dim=0)
    y = torch.sqrt(y + 1e-8)
    y = torch.mean(y, dim=(2, 3, 4))  # [bs // ng, f]
    y = y.reshape(1, bs // ng, f, 1, 1).expand(ng, bs // ng, f, h, w)
    return torch.cat((x, y.reshape(bs, f, h, w)), dim=1)


class DiscriminatorOutput(nn.Module):
    """The 4x4 epilogue: minibatch std, conv, fc, out, and the projection
    on the conditioning map."""

    def __init__(self, in_channels, cmap_dim, resolution, mbstd_group_size=4,
                 mbstd_num_channels=1):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.conv = EqualizedConv2d(in_channels + mbstd_num_channels, in_channels, 3,
                                    activate=True)
        self.fc = EqualizedLinear(in_channels * resolution**2, in_channels,
                                  activate=True)
        self.out = EqualizedLinear(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, cmap=None):
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        # NCHW flattening: the order the reference's fc weights take.
        x = self.fc(x.reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = torch.sum(x * cmap, dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x


class DiscriminatorBackbone(nn.Module):
    """StyleGAN2 discriminator with optional projection conditioning:
    images NHWC [B, R, R, img_channels], c [B, c_dim] -> logits [B, 1]."""

    def __init__(self, c_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, cmap_dim=None, mapping_lr_multiplier=0.01,
                 mapping_num_layers=2):
        super().__init__()
        self.c_dim = c_dim
        self.resolutions = [2**i for i in range(int(math.log2(img_resolution)), 2, -1)]
        channels = {res: min(channel_base // res, channel_max)
                    for res in self.resolutions + [4]}
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        for res in self.resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels[res] if res < img_resolution else 0, channels[res],
                channels[res // 2], img_channels))
        if c_dim > 0:
            self.mapping = MappingNetwork(
                z_dim=0, c_dim=c_dim, w_dim=cmap_dim, num_ws=None,
                num_layers=mapping_num_layers, lr_multiplier=mapping_lr_multiplier,
                normalize_c=False)
        self.b4 = DiscriminatorOutput(channels[4], cmap_dim=cmap_dim, resolution=4)

    def forward(self, img, c=None):
        x = None
        img = img.permute(0, 3, 1, 2)
        for res in self.resolutions:
            x, img = getattr(self, f"b{res}")(x, img)
        cmap = None
        if self.c_dim == -1:
            cmap = c
        elif self.c_dim > 0:
            cmap = self.mapping(None, c)
        return self.b4(x, cmap)
