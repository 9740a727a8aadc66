"""Image metrics on the device: PSNR, SSIM, IoU.

Counterpart of nerf_from_image_tpu/metrics/image.py. SSIM uses valid-window
depthwise mean filters (uniform 7x7 window, K1=0.01, K2=0.03), which
matches skimage's structural_similarity on the interior region.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean",
         mask: Optional[torch.Tensor] = None, max_db: float = 60.0) -> torch.Tensor:
    """PSNR over [0, 1] images [B, H, W, C], clamped at 60 dB per sample.

    With `mask` [B, H, W] the metric is taken over the masked pixels only
    (one pooled value)."""
    pred = torch.clamp(pred, 0.0, 1.0)
    target = torch.clamp(target, 0.0, 1.0)
    se = torch.square(pred - target)
    if mask is not None:
        m = (mask > 0).to(pred.dtype)[..., None]
        mse = torch.sum(se * m) / torch.clamp_min(torch.sum(m) * pred.shape[-1], 1.0)
        batch = -10.0 * torch.log10(mse)
    else:
        batch = -10.0 * torch.log10(torch.mean(se, dim=(1, 2, 3)))
    batch = torch.clamp_max(batch, max_db)
    return torch.mean(batch) if reduction == "mean" else batch


def _valid_mean_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """win x win mean filter, VALID padding, per channel; NHWC in and out."""
    C = x.shape[-1]
    kernel = torch.full((C, 1, win, win), 1.0 / (win * win), dtype=x.dtype,
                        device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=C)
    return y.permute(0, 2, 3, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean",
         win_size: int = 7, data_range: float = 1.0, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of [B, H, W, C] images in [0, 1]."""
    pred = torch.clamp(pred, 0.0, 1.0)
    target = torch.clamp(target, 0.0, 1.0)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    ux = _valid_mean_filter(pred, win_size)
    uy = _valid_mean_filter(target, win_size)
    uxx = _valid_mean_filter(pred * pred, win_size)
    uyy = _valid_mean_filter(target * target, win_size)
    uxy = _valid_mean_filter(pred * target, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    batch = torch.mean(s, dim=(1, 2, 3))
    return torch.mean(batch) if reduction == "mean" else batch


def iou(alpha_pred: torch.Tensor, alpha_real: torch.Tensor, reduction: str = "mean",
        threshold: float = 0.5) -> torch.Tensor:
    """Mask IoU of [B, H, W] (or [B, 1, H, W]) alphas in [0, 1]."""
    p = alpha_pred > threshold
    r = alpha_real > threshold
    inter = torch.sum((p & r).float(), dim=(-2, -1))
    union = torch.sum((p | r).float(), dim=(-2, -1))
    batch = (inter + 1e-6) / (union + 1e-6)
    return torch.mean(batch) if reduction == "mean" else batch.reshape(-1)
