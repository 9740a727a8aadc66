"""Hybrid inversion: Adam on (w, pose) through the differentiable render.

Counterpart of nerf_from_image_tpu/engine/inversion.py. Each step builds
the camera from the pose leaves, renders, takes the reconstruction loss,
runs one torch.optim.Adam step (optax.adam's update: eps 1e-8 outside the
square root, the same bias correction) and projects the pose back onto
its constraints (z0 in [-4, 4], s >= 0, unit q). The latent is optimized
as z = w / lr_gain_z, so its effective learning rate is lr * gain.

The perceptual losses ('vgg', the default, 'vgg_nocrop' and 'mixed') take
an LPIPS module; 'vgg' and 'mixed' compare `num_augmentations` crop-
augmented copies of the (render, target) pair besides the pair itself.
Each step draws its transforms from the call's generator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from nerf_from_image_tpu_torch.engine import augment as augment_mod
from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.pose.pose import matrix_to_pose, pose_to_matrix
from nerf_from_image_tpu_torch.utils.device import check_on_device, resolve_device

LOSSES = ("vgg", "vgg_nocrop", "l1", "mse", "mixed")
_PERCEPTUAL_LOSSES = ("vgg", "vgg_nocrop", "mixed")


@dataclasses.dataclass(frozen=True)
class InversionConfig:
    steps: int = 30
    lr: float = 2e-3
    b1: float = 0.9
    b2: float = 0.95
    lr_gain_z: float = 5.0
    loss: str = "vgg"  # one of LOSSES
    num_augmentations: int = 15
    optimize_pose: bool = True
    # Hold a known focal fixed while R/s/t are optimized: z0's gradient is
    # zeroed, so Adam's moments for it stay zero and it never moves.
    optimize_focal: bool = True
    camera_flipped: bool = False
    # Padding of the crop-augmented loss views: white on white-background
    # datasets.
    white_background: bool = False


class PoseParams(NamedTuple):
    """Optimizable pose leaves (z0 is None for orthographic cameras)."""

    z0: Optional[torch.Tensor]
    t2: torch.Tensor
    s: torch.Tensor
    q: torch.Tensor


def pose_params_from_matrix(pose, focal, camera_flipped: bool) -> PoseParams:
    return PoseParams(*matrix_to_pose(pose, focal, camera_flipped))


def _normalize_q(q):
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


def build_camera(params: PoseParams, camera_flipped: bool):
    return pose_to_matrix(
        params.z0, params.t2, params.s, _normalize_q(params.q), camera_flipped
    )


def _project(params: PoseParams) -> PoseParams:
    """Post-step constraint projection."""
    z0 = None if params.z0 is None else torch.clamp(params.z0, -4.0, 4.0)
    return PoseParams(z0, params.t2, torch.abs(params.s), _normalize_q(params.q))


def _abs(x):
    # jnp.abs's gradient at 0 is 1 (torch.abs gives 0); the select keeps
    # the JAX package's value at an exact tie.
    return torch.where(x >= 0, x, -x)


def _check_loss(config: InversionConfig, lpips) -> None:
    if config.loss not in LOSSES:
        raise ValueError(f"inversion loss {config.loss!r} is not one of {LOSSES}")
    if config.loss in _PERCEPTUAL_LOSSES and lpips is None:
        raise ValueError(f"inversion loss {config.loss!r} needs an LPIPS module")


def reconstruction_loss(config: InversionConfig, lpips, rgb_predicted: torch.Tensor,
                        target: torch.Tensor, target_features=None,
                        generator: Optional[torch.Generator] = None,
                        tform: Optional[augment_mod.AugmentTransform] = None
                        ) -> torch.Tensor:
    """Crop-augmented perceptual and/or pixel loss, summed over the batch
    (the mean times B).

    rgb_predicted/target: [B, H, W, 3] in [-1, 1]. target_features: the
    target's cached LPIPS features, used when no augmentation runs. The
    augmentation transform for the B * num_augmentations copies is drawn
    from `generator` unless `tform` is given.
    """
    _check_loss(config, lpips)
    B = rgb_predicted.shape[0]
    loss = 0.0
    if config.loss in _PERCEPTUAL_LOSSES:
        pred_aug = rgb_predicted
        tgt_aug = target if target_features is None else target_features
        if config.loss != "vgg_nocrop" and config.num_augmentations > 0:
            pair = torch.cat((rgb_predicted, target), dim=-1)
            pair = torch.repeat_interleave(pair, config.num_augmentations, dim=0)
            pair_aug, _, _, _ = augment_mod.augment(
                generator, pair, None, None, 1.0,
                white_background=config.white_background, tform=tform,
            )
            pred_aug = torch.cat((rgb_predicted, pair_aug[..., :3]), dim=0)
            tgt_aug = torch.cat((target, pair_aug[..., 3:]), dim=0)
        loss = loss + torch.mean(lpips(pred_aug, tgt_aug)) * B
    if config.loss in ("l1", "mixed"):
        loss = loss + torch.mean(_abs(rgb_predicted - target)) * B
    if config.loss == "mse":
        loss = torch.mean(torch.square(rgb_predicted - target)) * B
    if config.loss == "mixed":
        loss = loss / 2.0
    return loss


def make_invert_fn(config: InversionConfig, render_config: RenderConfig, model,
                   lpips=None, device="cuda"):
    """Builds the inversion routine

        invert(z, pose_params, target_img, generator=None, center=None,
               bbox=None, n_steps=None) -> (z, pose_params, losses [n])

    `z` is the pre-gain latent (w_init / lr_gain_z), [B, 1, w_dim].
    `lpips` (models/lpips.py) is needed by the perceptual losses; the
    target's features are computed once per call. `generator` drives the
    render's sampling and the augmentation draws; with `generator=None`
    the render is deterministic and the draws come from a generator seeded
    0 on the device, so the call is repeatable. Tensors must lie on
    `device` ('cuda' by default, which needs a card).
    """
    dev = resolve_device(device)
    _check_loss(config, lpips)

    def render_current(z, pose_params, generator, center, bbox):
        cam, focal = build_camera(pose_params, config.camera_flipped)
        out, _ = render(
            render_config, model, cam, focal, z * config.lr_gain_z,
            center=center, bbox=bbox, generator=generator,
            force_no_cam_grad=not config.optimize_pose, device=dev,
        )
        return out

    def invert(z, pose_params: PoseParams, target_img, generator=None,
               center=None, bbox=None, n_steps: Optional[int] = None):
        check_on_device(dev, z=z, target_img=target_img, q=pose_params.q)
        n = config.steps if n_steps is None else n_steps
        target = target_img[..., :3]
        target_features = None
        if config.loss in _PERCEPTUAL_LOSSES:
            with torch.no_grad():
                target_features = lpips.features(target)
        aug_generator = generator
        if aug_generator is None:
            aug_generator = torch.Generator(device=dev).manual_seed(0)
        z = z.detach().clone().requires_grad_(True)
        pose = PoseParams(*(
            None if t is None else t.detach().clone().requires_grad_(
                config.optimize_pose
            )
            for t in pose_params
        ))
        leaves = [z]
        if config.optimize_pose:
            leaves += [t for t in pose if t is not None]
        opt = torch.optim.Adam(leaves, lr=config.lr,
                               betas=(config.b1, config.b2), eps=1e-8)
        losses = []
        for _ in range(n):
            out = render_current(z, pose, generator, center, bbox)
            loss = reconstruction_loss(config, lpips, out.rgb[..., :3], target,
                                       target_features, aug_generator)
            # Gradients of the optimized leaves only: the generator's
            # parameters take none.
            for leaf, grad in zip(leaves, torch.autograd.grad(loss, leaves)):
                leaf.grad = grad
            if config.optimize_pose and not config.optimize_focal and pose.z0 is not None:
                pose.z0.grad = torch.zeros_like(pose.z0)
            opt.step()
            if config.optimize_pose:
                with torch.no_grad():
                    for leaf, projected in zip(pose, _project(pose)):
                        if leaf is not None:
                            leaf.copy_(projected)
            losses.append(loss.detach())
        final_pose = PoseParams(*(None if t is None else t.detach() for t in pose))
        return z.detach(), final_pose, torch.stack(losses)

    return invert
