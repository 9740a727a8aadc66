"""Generator regularizers: path length, eikonal, SDF distance, TV, entropy.

Counterpart of nerf_from_image_tpu/engine/regularizers.py. Each one is a
torch.autograd.grad with create_graph=True inside the loss, so the loss's
own backward is a double backward. Every field query here decodes the raw
planes through the grid-sample branch (Generator.decode), which autograd
differentiates to any order; the splat op's backward is first-order only
and raises under a second derivative.

Random draws (the stratified samples, the TV perturbation, the
path-length noise) come from an explicit torch.Generator, or are handed
in, which the parity tests do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from port_bench.reference.models.generator import laplace_cdf, laplace_pdf
from port_bench.reference.ops.sampling import sample_volume_stratified
from port_bench.reference.parallel import mesh

NSTRATA = 32


def abs_jax(x):
    # jnp.abs's gradient at 0 is 1 (torch.abs gives 0); the select keeps
    # the JAX package's value at an exact tie, which saturated densities
    # reach.
    return torch.where(x >= 0, x, -x)


def path_length_noise(model, planes_shape, generator: Optional[torch.Generator],
                      device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The random output directions of path_length: planes noise scaled by
    1/sqrt(H * W), and the palette's when the generator has one."""
    noise_p = mesh.draw(torch.randn, planes_shape, generator=generator, device=device)
    noise_p = noise_p / math.sqrt(planes_shape[2] * planes_shape[3])
    noise_a = None
    if model.attention_values > 0:
        noise_a = mesh.draw(torch.randn, (planes_shape[0], model.attention_values, 3),
                            generator=generator, device=device)
    return noise_p, noise_a


def path_length(model, ws: torch.Tensor, noise=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample path length ||J^T y|| [B] of the synthesis map (planes,
    and the attention palette) at random output directions y = `noise`
    (path_length_noise), differentiable with respect to `ws` and the
    parameters."""
    if not ws.requires_grad:
        ws = ws.detach().requires_grad_(True)
    planes = model.synthesize(ws)
    if noise is None:
        noise = path_length_noise(model, tuple(planes.shape), generator, ws.device)
    noise_p, noise_a = noise
    outputs, grad_outputs = [planes], [noise_p]
    if model.attention_values > 0:
        outputs.append(model.texture(ws))
        grad_outputs.append(noise_a)
    (g,) = torch.autograd.grad(outputs, ws, grad_outputs, create_graph=True)
    return torch.sqrt(torch.mean(torch.sum(torch.square(g), dim=-1), dim=-1))


def volume_samples(model, batch_size: int, generator: Optional[torch.Generator],
                   device, nstrata: int = NSTRATA):
    """The draws of volume_regularizers: (stratified points [B, N, 3], the
    TV perturbation noise [B, N, 3])."""
    bins = sample_volume_stratified(generator, batch_size, nstrata, model.scene_range,
                                    device=device)
    return bins, mesh.draw(torch.randn, bins.shape, generator=generator, device=device)


def volume_regularizers(
    model,
    planes: torch.Tensor,
    bins: torch.Tensor,
    perturb: Optional[torch.Tensor] = None,
    want_eikonal: bool = True,
    want_distance: bool = False,
    want_tv: bool = True,
    want_entropy: bool = True,
) -> Dict[str, torch.Tensor]:
    """Eikonal / SDF-distance / total-variation / entropy losses per batch
    element [B] over the points `bins` [B, N, 3] (volume_samples);
    `perturb` [B, N, 3] is the TV perturbation's unit noise."""
    out: Dict[str, torch.Tensor] = {}

    def distance_at(pts):
        d, _ = model.decode(planes, pts / model.scene_range)
        return d[..., -1]

    if want_eikonal:
        with torch.enable_grad():
            pts = bins.detach().requires_grad_(True)
            distance = distance_at(pts)
            (grad,) = torch.autograd.grad(distance.sum(), pts, create_graph=True)
        sdf_magnitude = torch.linalg.vector_norm(grad, dim=-1)
        out["sdf_eikonal_loss"] = torch.mean(torch.square(sdf_magnitude - 1.0), dim=1)
    else:
        distance = distance_at(bins)

    if want_distance:
        target = (torch.linalg.vector_norm(bins, dim=-1) - 1.0).detach()  # Unit sphere.
        out["sdf_distance_loss"] = torch.mean(torch.square(distance - target), dim=1)

    if want_tv or want_entropy:
        d_perturb = None
        if want_tv:
            coords = (bins / model.scene_range).detach()
            coords_perturb = coords + perturb * 0.004
            d_perturb = model.decode(planes, coords_perturb)[0][..., -1]
        if model.use_sdf:
            beta = model.beta[0]
            neg_distance = -distance
            if want_tv:
                pre = laplace_cdf(neg_distance, beta)
                pre_perturb = laplace_cdf(-d_perturb, beta)
                out["total_variation_loss"] = torch.mean(abs_jax(pre - pre_perturb), dim=1)
            if want_entropy:
                out["entropy_loss"] = torch.mean(laplace_pdf(neg_distance, beta), dim=1)
        else:
            tv_term = torch.sigmoid(distance - 1.0)
            if want_tv:
                tv_perturb = torch.sigmoid(d_perturb - 1.0)
                out["total_variation_loss"] = torch.mean(abs_jax(tv_term - tv_perturb), dim=1)
            if want_entropy:
                out["entropy_loss"] = torch.mean(tv_term * (1.0 - tv_term), dim=1)
    return out


def sdf_pretrain_losses(model, ws: torch.Tensor, bins: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Unit-sphere SDF fitting and eikonal at the points `bins`, for the
    SDF pretraining phase."""
    planes = model.synthesize(ws)
    return volume_regularizers(model, planes, bins, want_eikonal=True,
                               want_distance=True, want_tv=False, want_entropy=False)
