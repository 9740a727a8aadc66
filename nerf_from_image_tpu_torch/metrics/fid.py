"""Frechet Inception Distance: statistics and distance on the device.

Counterpart of nerf_from_image_tpu/metrics/fid.py. The matrix square root
is a Newton-Schulz iteration (matmuls only, no eigendecomposition and no
host round trip), and the cross term takes the square root of the
symmetric form sqrt(S2) S1 sqrt(S2), which shares its trace with
sqrtm(S1 S2). Everything runs in the caller's dtype, as the JAX package
does in f32.

With fewer activations than dimensions (fewer than 2,048 images of
Inception features) a covariance is singular, and 30 f32 iterations then
diverge to NaN, in the JAX package as here: rounding errors along the
null directions grow by 1.5 an iteration. In float64 they stay small and
the distance converges to the eigenvalue reference, so the drivers
(engine/gan_eval.py, engine/evaluate.py's report) hand over float64
statistics (FID_DTYPE). The algorithm is the JAX package's either way.
"""

from __future__ import annotations

from typing import Tuple

import torch

# The dtype of the drivers' statistics and distances (see above).
FID_DTYPE = torch.float64


def calculate_stats(activations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and covariance of [N, D] activations (rowvar=False, ddof=1)."""
    mu = torch.mean(activations, dim=0)
    x = activations - mu
    sigma = (x.T @ x) / (activations.shape[0] - 1)
    return mu, sigma


def sqrtm_newton_schulz(a: torch.Tensor, num_iters: int = 30,
                        eps: float = 1e-12) -> torch.Tensor:
    """Matrix square root of a (near-)PSD matrix by the coupled
    Newton-Schulz iteration, after a Frobenius normalization (which makes
    ||A / ||A||_F - I|| < 1, where the iteration converges)."""
    dim = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a)) + eps
    y = a / norm
    z = torch.eye(dim, dtype=a.dtype, device=a.device)
    eye3 = 3.0 * torch.eye(dim, dtype=a.dtype, device=a.device)
    for _ in range(num_iters):
        t = 0.5 * (eye3 - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def trace_sqrt_product(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """tr(sqrtm(S1 S2)), the cross term of the Frechet distance, through the
    similar symmetric matrix sqrt(S2) S1 sqrt(S2) (symmetrized)."""
    s2_half = sqrtm_newton_schulz(sigma2)
    sym = s2_half @ sigma1 @ s2_half
    sym = 0.5 * (sym + sym.T)
    return torch.trace(sqrtm_newton_schulz(sym))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> torch.Tensor:
    """FID between two activation Gaussians; both covariances get eps * I,
    as the reference regularizes singular ones. The real statistics may be
    numpy arrays; they are moved to the first pair's device and dtype."""
    mu1 = torch.as_tensor(mu1)
    sigma1 = torch.as_tensor(sigma1)
    mu2 = torch.as_tensor(mu2, dtype=mu1.dtype, device=mu1.device)
    sigma2 = torch.as_tensor(sigma2, dtype=sigma1.dtype, device=sigma1.device)
    offset = eps * torch.eye(sigma1.shape[0], dtype=sigma1.dtype, device=sigma1.device)
    diff = mu1 - mu2
    tr_covmean = trace_sqrt_product(sigma1 + offset, sigma2 + offset)
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_covmean
