"""Inversion evaluation: per-checkpoint metrics.

At each checkpoint step the recovered (w, pose) is rendered from the
front view (and from the paired novel view when one is given), and PSNR,
SSIM, IoU, LPIPS and the rotation error are taken per sample, without
gradients; with an Inception model, the front and novel views'
activations too.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference.engine.inversion import (
    InversionConfig,
    PoseParams,
    build_camera,
)
from port_bench.reference.engine.render import RenderConfig, render
from port_bench.reference.metrics import image as image_metrics
from port_bench.reference.pose.pose import rotation_matrix_distance
from port_bench.reference.utils.device import check_on_device, resolve_device


def make_eval_fn(
    config: InversionConfig,
    render_config: RenderConfig,
    model,
    lpips,
    inception_model=None,
    has_mask: bool = True,
    device="cuda",
):
    """Builds the per-batch checkpoint evaluation

        eval_fn(z, pose_params, target_img, gt_cam2world=None,
                perm_pose=None, perm_focal=None, perm_target=None,
                center=None, bbox=None, perm_center=None, perm_bbox=None)
        -> {metric: [B] tensor}

    `z` is the pre-gain latent, as make_invert_fn takes it; target_img
    [B, H, W, 3 or 4] in [-1, 1], a fourth channel being the mask (IoU
    when `has_mask`). `lpips` is models/lpips.py's LPIPS. With
    `inception_model` (models/inception.py's FIDInceptionV3) the result
    also holds 'inception_activations_front' [B, 2048] and, with a
    `perm_pose`, 'inception_activations_random'; the novel view is then
    rendered even without `perm_target`. Renders are deterministic and
    take no gradient. Tensors must lie on `device` ('cuda' by default,
    which needs a card).
    """
    dev = resolve_device(device)

    def render_view(z, cam, focal, center, bbox):
        out, _ = render(
            render_config, model, cam, focal, z * config.lr_gain_z,
            center=center, bbox=bbox, force_no_cam_grad=True, device=dev,
        )
        return out

    @torch.no_grad()
    def eval_fn(z, pose_params: PoseParams, target_img, gt_cam2world=None,
                perm_pose=None, perm_focal=None, perm_target=None, center=None,
                bbox=None, perm_center=None, perm_bbox=None
                ) -> Dict[str, torch.Tensor]:
        check_on_device(dev, z=z, target_img=target_img, q=pose_params.q,
                        gt_cam2world=gt_cam2world, perm_pose=perm_pose)
        cam, focal = build_camera(pose_params, config.camera_flipped)
        out = render_view(z, cam, focal, center, bbox)
        pred = torch.clamp(out.rgb[..., :3], -1.0, 1.0)
        target = target_img[..., :3]

        res: Dict[str, torch.Tensor] = {}
        res["psnr"] = image_metrics.psnr(pred / 2 + 0.5, target / 2 + 0.5,
                                         reduction="none")
        res["ssim"] = image_metrics.ssim(pred / 2 + 0.5, target / 2 + 0.5,
                                         reduction="none")
        if has_mask and target_img.shape[-1] > 3:
            res["iou"] = image_metrics.iou(out.mask, target_img[..., 3],
                                           reduction="none")
        res["lpips"] = lpips(pred, target).reshape(-1)
        if gt_cam2world is not None:
            res["rot_error"] = rotation_matrix_distance(cam, gt_cam2world)
        if inception_model is not None:
            res["inception_activations_front"] = inception_model(pred / 2 + 0.5)

        if perm_pose is not None and (perm_target is not None
                                      or inception_model is not None):
            out_r = render_view(z, perm_pose, perm_focal, perm_center, perm_bbox)
            pred_r = torch.clamp(out_r.rgb[..., :3], -1.0, 1.0)
            if perm_target is not None:
                target_r = perm_target[..., :3]
                res["psnr_random"] = image_metrics.psnr(
                    pred_r / 2 + 0.5, target_r / 2 + 0.5, reduction="none")
                res["ssim_random"] = image_metrics.ssim(
                    pred_r / 2 + 0.5, target_r / 2 + 0.5, reduction="none")
                res["lpips_random"] = lpips(pred_r, target_r).reshape(-1)
            if inception_model is not None:
                res["inception_activations_random"] = inception_model(pred_r / 2 + 0.5)
        return res

    return eval_fn
