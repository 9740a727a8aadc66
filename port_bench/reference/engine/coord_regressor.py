"""Bootstrap-encoder training: distillation of the frozen EMA generator,
the plain reference of the benchmark's distillation cell.

A copy of the port's engine/coord_regressor.py as it stood at commit
f23bdf4 (before the port named its ranges), with its imports pointed at
this package; plain PyTorch, run in float32 with TF32 off. One step draws
z, maps it through the frozen mapping network, renders the target image,
mask and canonical-coordinate map with compute_coords without gradients,
and trains the SegFormer encoder, with drop path on, to regress the
coordinates (mask-weighted L2 norm), the mask (L1) and the first w (MSE),
then takes one Adam step.

Where it departs from the paper's trainer (run.py:1521-1706,
train_coord_regressor), as the port does:
- the optimizer is optax.adam with the step schedule written out (lr
  while the update count, taken before its increment, is below
  lr_drop_at, then lr / 10; eps added outside the square root), where
  run.py steps torch.optim.Adam and a scheduler, which moves the rate at
  another count;
- at an exact zero coordinate difference the norm's gradient is 0
  (torch's subgradient of linalg.vector_norm), which run.py leaves to
  torch.norm and the JAX package gives as NaN;
- the mask's L1 takes the gradient 1 at a tie (inversion._abs, JAX's
  rule), where torch.abs gives 0;
- z, the render's samples and the drop-path masks come from one
  torch.Generator handed to the step, drawn at the global batch's shape
  (parallel/mesh.py is one process here), not from torch's global
  generator;
- the target image is clipped to [-1, 1] before the encoder sees it.
The benchmark also starts from random weights made from its seed, where
run.py loads the pretrained generator and the ImageNet mit_b5 backbone,
and takes cameras from its traffic, not the train split.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from port_bench.reference.engine.gan import Optimizer, param_grads
from port_bench.reference.engine.inversion import _abs
from port_bench.reference.engine.render import RenderConfig, render
from port_bench.reference.parallel import mesh
from port_bench.reference.utils.device import check_on_device, resolve_device


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
    """(total loss, {'loss_coords', 'loss_mask', 'loss_latent'})."""
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
    coordinates [B, H, W, 3], w [B, 1, w_dim])."""
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
    in place through `opt` and returns the losses ('loss' and its terms,
    detached). z is drawn from `generator` when not given; `generator`
    also draws the render's samples and the encoder's drop path."""
    dev = resolve_device(device)
    check_on_device(dev, pose=batch["pose"], z=z)
    if z is None:
        z = mesh.draw(torch.randn, (batch["pose"].shape[0], config.latent_dim),
                      generator=generator, device=dev)
    image, mask, coords, w = render_targets(render_config, generator_ema, batch, z,
                                            generator, dev)
    pred_coords, pred_mask, pred_w = encoder(image, deterministic=False, generator=generator)
    loss, losses = coord_losses(pred_coords, pred_mask, pred_w, coords, mask, w)
    opt.step(param_grads(loss, opt.params))
    losses["loss"] = loss
    return {k: v.detach() for k, v in losses.items()}
