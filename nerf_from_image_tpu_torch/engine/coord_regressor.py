"""Bootstrap-encoder training: distillation of the frozen EMA generator.

Counterpart of nerf_from_image_tpu/engine/coord_regressor.py (the
reference's coordinate-regressor trainer, run.py:1521-1706). One step
draws z, maps it through the frozen EMA mapping network, renders the
target image, mask and canonical-coordinate map with compute_coords
(without gradients, so the splat op launches no kernel), and trains the
SegFormer encoder, with drop path on, to regress the coordinates
(mask-weighted L2 norm), the mask (L1) and the first w (MSE). The
generator is the data source: there is no input pipeline.

The optimizer is optax.adam with the step schedule written out (lr while
the update count is below lr_drop_at, then lr / 10; the count is taken
before its increment), as engine/gan.py's Optimizer evaluates optax's
chain: torch.optim.Adam with a scheduler would move the rate at another
count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch.engine.gan import Optimizer, param_grads
from nerf_from_image_tpu_torch.engine.inversion import _abs
from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.utils.device import check_on_device, resolve_device


@dataclasses.dataclass(frozen=True)
class CoordRegressorConfig:
    latent_dim: int = 512
    lr: float = 6e-5
    max_iters: int = 120000
    lr_drop_at: int = 60000  # max_iters // 2: lr / 10 from there


def lr_schedule(config: CoordRegressorConfig) -> Callable[[int], float]:
    """The learning rate at an update count, in f32 as optax evaluates it."""
    high = float(np.float32(config.lr))
    low = float(np.float32(config.lr / 10.0))
    return lambda count: high if count < config.lr_drop_at else low


def make_optimizer(config: CoordRegressorConfig, encoder: torch.nn.Module) -> Optimizer:
    """optax.adam(schedule) over the encoder's parameters (b1 0.9, b2 0.999,
    eps 1e-8 added outside the square root, bias-corrected)."""
    return Optimizer(list(encoder.parameters()), lr_schedule(config), b1=0.9, b2=0.999,
                     eps=1e-8)


def coord_losses(pred_coords, pred_mask, pred_w, target_coords, target_mask, target_w):
    """(total loss, {'loss_coords', 'loss_mask', 'loss_latent'}): the
    reference's three terms. At an exact zero coordinate difference the
    norm's gradient is 0 here (torch's subgradient); JAX's is NaN there.
    The mask's L1 takes JAX's gradient of 1 at a tie."""
    losses = {
        "loss_coords": torch.mean(
            torch.linalg.vector_norm(pred_coords - target_coords, dim=-1) * target_mask),
        "loss_mask": torch.mean(_abs(pred_mask - target_mask)),
        "loss_latent": torch.mean(torch.square(pred_w - target_w)),
    }
    return losses["loss_coords"] + losses["loss_mask"] + losses["loss_latent"], losses


@torch.no_grad()
def render_targets(render_config: RenderConfig, generator_ema, batch: Dict[str, torch.Tensor],
                   z: torch.Tensor, generator: Optional[torch.Generator] = None, device="cuda"):
    """The distillation targets of latents z [B, latent_dim] at the batch's
    cameras: (image [B, H, W, 3] clipped to [-1, 1], mask [B, H, W],
    coordinates [B, H, W, 3], w [B, 1, w_dim]). Class-conditional
    generators map z with the batch's 'classes'."""
    w = generator_ema.mapping(z, batch.get("classes"))
    out, _ = render(dataclasses.replace(render_config, compute_coords=True), generator_ema,
                    batch["pose"], batch.get("focal"), w, center=batch.get("center"),
                    bbox=batch.get("bbox"), generator=generator, device=device)
    return torch.clamp(out.rgb[..., :3], -1.0, 1.0), out.mask, out.semantics, w[:, :1]


def coord_train_step(
    config: CoordRegressorConfig,
    render_config: RenderConfig,
    generator_ema,
    encoder,
    opt: Optimizer,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """One sample -> render -> regress -> update step; updates the encoder
    in place through `opt` (make_optimizer) and returns the losses
    ('loss' and its terms, detached, on the device).

    batch: the camera draws {'pose', 'focal', 'center', 'bbox', 'classes'}
    of the train split (all but 'pose' optional). z [B, latent_dim] is
    drawn from `generator` when not given; `generator` also draws the
    render's samples and the encoder's drop path (None: a deterministic
    render, and drop path from torch's default generator).
    """
    dev = resolve_device(device)
    check_on_device(dev, pose=batch["pose"], z=z)
    if z is None:
        z = torch.randn((batch["pose"].shape[0], config.latent_dim), generator=generator,
                        device=dev)
    image, mask, coords, w = render_targets(render_config, generator_ema, batch, z,
                                            generator, dev)
    pred_coords, pred_mask, pred_w = encoder(image, deterministic=False, generator=generator)
    loss, losses = coord_losses(pred_coords, pred_mask, pred_w, coords, mask, w)
    opt.step(param_grads(loss, opt.params))
    losses["loss"] = loss
    return {k: v.detach() for k, v in losses.items()}
