"""The first guess of the hybrid inversion: the encoder's w and the
pose that PnP finds on its coordinate map."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from port_bench.reference.engine.inversion import (
    InversionConfig,
    PoseParams,
    pose_params_from_matrix,
)
from port_bench.reference.pose.pnp import estimate_poses_batch
from port_bench.reference.utils.device import check_on_device, resolve_device


@torch.no_grad()
def first_guess(
    encoder,
    target_img: torch.Tensor,
    z_avg: torch.Tensor,
    config: InversionConfig,
    focal_guesses: Optional[np.ndarray] = None,
    pose: Optional[torch.Tensor] = None,
    focal: Optional[torch.Tensor] = None,
    no_split: bool = False,
    device="cuda",
) -> Tuple[torch.Tensor, PoseParams]:
    """The starting point of the inversion: (z0 [B, num_ws or 1, w_dim],
    pose params).

    target_img: [B, H, W, 3 or more] in [-1, 1]. z_avg: the generator's
    average w [1, num_ws, w_dim]. With `encoder` (models/encoder.py's
    BootstrapEncoder) z0 is its w broadcast to every layer, and the pose
    comes from PnP on its coordinate map with `focal_guesses`
    (pose/pnp.py::get_focal_guesses of the train focals; None for
    orthographic datasets). A head the encoder lacks, or encoder=None,
    leaves z0 at z_avg and the pose at (`pose`, `focal`). z0 is divided by
    config.lr_gain_z, as make_invert_fn takes it; `no_split` averages it
    over the layers (one w optimized for all). Tensors must lie on
    `device` ('cuda' by default, which needs a card).
    """
    dev = resolve_device(device)
    check_on_device(dev, target_img=target_img, z_avg=z_avg, pose=pose, focal=focal)
    bs = target_img.shape[0]
    w = z_avg
    if encoder is not None:
        coords, mask, w_pred = encoder(target_img[..., :3])
        if coords is not None:
            pose, est_focal, _ = estimate_poses_batch(coords, mask, focal_guesses)
            if est_focal is not None:
                focal = est_focal
        if w_pred is not None:
            w = w_pred
    if pose is None:
        raise ValueError("no pose: pass one, or an encoder with a pose head")
    z0 = w.expand((bs,) + tuple(z_avg.shape[1:])) / config.lr_gain_z
    if no_split:
        z0 = torch.mean(z0, dim=1, keepdim=True)
    return z0, pose_params_from_matrix(pose, focal, config.camera_flipped)
