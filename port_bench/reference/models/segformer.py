"""SegFormer (MiT-B5) backbone + all-MLP decode head.

Counterpart of nerf_from_image_tpu/models/segformer.py: a 4-stage
overlapping-patch-embedding transformer (depths (3, 6, 40, 3),
spatial-reduction ratios (8, 4, 2, 1)) fused to a 512-channel feature map
at 1/4 of the input resolution.

Convolutions run on NCHW maps; the transformer runs on [B, N, C] tokens,
with N the map's positions in row-major (H, W) order. Parameters keep the
torch layouts and, through `segformer_rename`, the reference state-dict
names that the JAX package stores. Attention is a plain matmul, softmax,
matmul. Drop-path is the identity at inference (`deterministic=True`);
in training it draws from an explicit torch.Generator.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.parallel import mesh
from port_bench.reference.utils.device import resolve_device


class TorchLinear(nn.Linear):
    """Linear layer initialized as the JAX package's: truncated normal
    weights (std 0.02, cut at 2 std), zero bias."""

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            self.bias.zero_()


class TorchConv(nn.Conv2d):
    """NCHW convolution initialized as the JAX package's: normal weights
    with std sqrt(2 / fan_out), fan_out = k * k * out / groups; zero bias."""

    def init_parameters(self, generator: torch.Generator):
        k = self.kernel_size[0]
        fan_out = k * k * self.out_channels // self.groups
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            self.bias.zero_()


class TorchLayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis (population variance), eps 1e-6 by
    default (the blocks and stage norms); 1e-5 in the patch embeddings and
    the spatial reduction."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: zeroes whole samples with probability `rate` and
    rescales the rest; the identity when deterministic or rate == 0."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = (mesh.draw(torch.rand, shape, generator=generator, device=x.device)
            < keep).to(x.dtype)
    return x * mask / keep


def tokens_to_map(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H*W, C] tokens (row-major) -> [B, C, H, W]."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], height, width)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] tokens (row-major)."""
    return x.flatten(2).transpose(1, 2)


class SegAttention(nn.Module):
    """Efficient self-attention: K/V from a spatially reduced map."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = TorchLinear(dim, dim)
        if sr_ratio > 1:
            self.sr = TorchConv(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = TorchLayerNorm(dim, eps=1e-5)
        self.kv = TorchLinear(dim, 2 * dim)
        self.proj = TorchLinear(dim, dim)

    def forward(self, x, height, width):
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        scale = 1.0 / math.sqrt(hd)
        q = self.q(x).reshape(B, N, nh, hd).transpose(1, 2)  # [B, nh, N, hd]
        if self.sr_ratio > 1:
            x_ = self.norm(map_to_tokens(self.sr(tokens_to_map(x, height, width))))
        else:
            x_ = x
        kv = self.kv(x_).reshape(B, -1, 2, nh, hd)
        k = kv[:, :, 0].transpose(1, 2)
        v = kv[:, :, 1].transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class _DepthwiseConv(nn.Module):
    """The 3x3 depthwise convolution (key `dwconv.dwconv`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = TorchConv(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class SegMLP(nn.Module):
    """fc1 -> 3x3 depthwise conv -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = TorchLinear(dim, hidden)
        self.dwconv = _DepthwiseConv(hidden)
        self.fc2 = TorchLinear(hidden, dim)

    def forward(self, x, height, width):
        x = self.fc1(x)
        x = map_to_tokens(self.dwconv(tokens_to_map(x, height, width)))
        return self.fc2(F.gelu(x))


class SegBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.0, sr_ratio: int = 1):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = TorchLayerNorm(dim)
        self.attn = SegAttention(dim, num_heads, sr_ratio)
        self.norm2 = TorchLayerNorm(dim)
        self.mlp = SegMLP(dim, dim * mlp_ratio)

    def forward(self, x, height, width, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        y = self.attn(self.norm1(x), height, width)
        x = x + drop_path(y, self.drop_path_rate, deterministic, generator)
        y = self.mlp(self.norm2(x), height, width)
        return x + drop_path(y, self.drop_path_rate, deterministic, generator)


class SegOverlapPatchEmbed(nn.Module):
    """Strided conv patch embedding -> (tokens [B, N, C], H, W)."""

    def __init__(self, patch_size: int, stride: int, in_channels: int, embed_dim: int):
        super().__init__()
        self.proj = TorchConv(in_channels, embed_dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.norm = TorchLayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        _, _, H, W = x.shape
        return self.norm(map_to_tokens(x)), H, W


def _resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centers. It is only ever an
    integer-factor upsample here, where it equals the JAX package's
    jax.image.resize(..., 'bilinear') (edge pixels clamp)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class _HeadProjection(nn.Module):
    """One stage's linear projection of the decode head (key
    `linear_cN.proj`)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.proj = TorchLinear(in_features, out_features)

    def forward(self, x):
        return self.proj(x)


def init_module(module: nn.Module, device, generator: Optional[torch.Generator]):
    """Initializes every parameter of `module` from `generator` (a CPU
    torch.Generator; None means seed 0), in module order, then moves it to
    `device`."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(generator)
    return module.to(resolve_device(device))


class Segformer(nn.Module):
    """MiT-B5 + all-MLP head: NCHW image [B, C_in, H, W] -> NCHW features
    [B, out_features, H/4, W/4].

    Parameters are drawn from `generator` and moved to `device` ('cuda' by
    default); device=None leaves them uninitialized on the CPU, for a
    parent module that initializes them itself.
    """

    def __init__(self, out_features: int = 512, in_channels: int = 3,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 drop_path_rate: float = 0.1,
                 depths: Sequence[int] = (3, 6, 40, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 decoder_dim: int = 768, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depths = tuple(depths)
        self.embed_dims = tuple(embed_dims)
        total = sum(self.depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur = 0
        for i in range(4):
            self.add_module(f"patch_embed{i + 1}", SegOverlapPatchEmbed(
                patch_size=7 if i == 0 else 3, stride=4 if i == 0 else 2,
                in_channels=in_channels if i == 0 else embed_dims[i - 1],
                embed_dim=embed_dims[i]))
            self.add_module(f"block{i + 1}", nn.ModuleList([
                SegBlock(embed_dims[i], num_heads[i], mlp_ratios[i], dpr[cur + j],
                         sr_ratios[i])
                for j in range(self.depths[i])
            ]))
            cur += self.depths[i]
            self.add_module(f"norm{i + 1}", TorchLayerNorm(embed_dims[i]))
        for i in range(4):
            self.add_module(f"linear_c{i + 1}", _HeadProjection(embed_dims[i], decoder_dim))
        self.linear_fuse = TorchConv(4 * decoder_dim, decoder_dim, 1)
        self.linear_pred = TorchConv(decoder_dim, out_features, 1)
        if device is not None:
            init_module(self, device, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B = x.shape[0]
        features = []  # per stage: (tokens [B, h*w, C], h, w)
        for i in range(4):
            tokens, H, W = getattr(self, f"patch_embed{i + 1}")(x)
            for block in getattr(self, f"block{i + 1}"):
                tokens = block(tokens, H, W, deterministic, generator)
            tokens = getattr(self, f"norm{i + 1}")(tokens)
            features.append((tokens, H, W))
            x = tokens_to_map(tokens, H, W)

        _, h0, w0 = features[0]
        all_c = []
        for i in reversed(range(4)):
            tokens, H, W = features[i]
            c = tokens_to_map(getattr(self, f"linear_c{i + 1}")(tokens), H, W)
            if i > 0:
                c = _resize_bilinear(c, (h0, w0))
            all_c.append(c)
        return self.linear_pred(self.linear_fuse(torch.cat(all_c, dim=1)))


def segformer_rename(path: str) -> str:
    """JAX (flax) parameter path -> reference state-dict key, which is this
    port's parameter name."""
    out = path.replace("dwconv_dwconv", "dwconv.dwconv")
    out = out.replace("_proj.", ".proj.")  # linear_cN_proj -> linear_cN.proj
    return re.sub(r"block(\d+)_(\d+)\.", r"block\1.\2.", out)
