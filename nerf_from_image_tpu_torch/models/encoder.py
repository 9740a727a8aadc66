"""Bootstrap encoder: SegFormer backbone -> (canonical coordinates, mask, w).

Counterpart of nerf_from_image_tpu/models/encoder.py: a SegFormer-B5
backbone whose 1/4-resolution features feed (a) a conv head, upsampled 4x,
regressing a 3-channel canonical coordinate map and a sigmoid foreground
mask, and (b) a pooled head regressing the latent w. Its first guess
starts the hybrid inversion (invert.py::first_guess).

The public API is NHWC, as in the JAX package: images [B, H, W, 3] in
[-1, 1]; the convolutions run on NCHW maps inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_from_image_tpu_torch.models.segformer import (
    Segformer,
    TorchConv,
    TorchLinear,
    _resize_bilinear,
    init_module,
    segformer_rename,
)


class BootstrapEncoder(nn.Module):
    """x [B, H, W, 3] -> (coords [B, H, W, 3], mask [B, H, W], w [B, 1,
    latent_dim]); a head that is switched off returns None.

    `backbone_depths` overrides MiT-B5's stage depths (3, 6, 40, 3), for
    small test models. Parameters are drawn from `generator` (a CPU
    torch.Generator; None means seed 0) and moved to `device`.
    """

    def __init__(self, latent_dim: int, pose_regressor: bool = True,
                 latent_regressor: bool = True, separate_backbones: bool = False,
                 backbone_depths: Sequence[int] = (3, 6, 40, 3), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pose_regressor = pose_regressor
        self.latent_regressor = latent_regressor
        self.separate_backbones = separate_backbones
        self.backbone = Segformer(out_features=512, depths=backbone_depths, device=None)
        if pose_regressor:
            # Keys post.0, post.2, post.4.
            self.post = nn.Sequential(
                TorchConv(512, 512, 3, padding=1), nn.ReLU(),
                TorchConv(512, 512, 3, padding=1), nn.ReLU(),
                TorchConv(512, 4, 3, padding=1),
            )
        if latent_regressor:
            if separate_backbones:
                self.backbone_latent = Segformer(out_features=512, depths=backbone_depths,
                                                 device=None)
            self.w_regressor_pre = nn.Sequential(TorchConv(512, 512, 3, padding=1))
            self.w_regressor_post = nn.Sequential(
                TorchLinear(512, 512), nn.ReLU(), TorchLinear(512, latent_dim),
            )
        init_module(self, device, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        x = x.permute(0, 3, 1, 2)
        features = self.backbone(x, deterministic, generator)  # [B, 512, H/4, W/4]

        coords = mask = w = None
        if self.pose_regressor:
            h, wd = features.shape[2:]
            up = F.relu(_resize_bilinear(features, (4 * h, 4 * wd)))
            maps = self.post(up).permute(0, 2, 3, 1)  # [B, H, W, 4]
            coords = maps[..., :3]
            mask = torch.sigmoid(maps[..., 3])

        if self.latent_regressor:
            features_latent = (
                self.backbone_latent(x, deterministic, generator)
                if self.separate_backbones else features
            )
            f = F.relu(self.w_regressor_pre(F.relu(features_latent)))
            f = self.w_regressor_post(torch.mean(f, dim=(2, 3)))
            f = torch.where(f >= 0, f, f * 0.2)  # LeakyReLU(0.2), as the mapping net
            w = f[:, None, :]

        return coords, mask, w


def encoder_rename(path: str) -> str:
    """JAX (flax) parameter path -> reference encoder state-dict key, which
    is this port's parameter name."""
    out = segformer_rename(path)
    for stem in ("post", "w_regressor_pre", "w_regressor_post"):
        for idx in ("0", "2", "4"):
            out = out.replace(f"{stem}_{idx}.", f"{stem}.{idx}.")
    return out
