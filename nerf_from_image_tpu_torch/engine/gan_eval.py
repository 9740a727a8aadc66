"""Training-time evaluation: FID over fixed latents, reconstruction metrics.

Counterpart of nerf_from_image_tpu/engine/gan_eval.py (the reference's
evaluate(), run.py:1200-1472): for the generation FID
(evaluate_recon's recon_mode None) the fixed z_fid latents are rendered
at the evaluation split's poses, their Inception activations stay on the
device, and FID is taken against the real images' statistics. In
encoder-conditional mode the renders reconstruct each evaluation image
from its own view ('front') or a paired novel view ('random') and are
scored with PSNR, SSIM, LPIPS and IoU. Every render runs without
gradients (so the splat op launches no kernel here).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.metrics import fid as fid_mod
from nerf_from_image_tpu_torch.metrics import image as image_metrics
from nerf_from_image_tpu_torch.parallel import mesh
from nerf_from_image_tpu_torch.utils.device import resolve_device, to_device


def inception_weights_path() -> Optional[str]:
    """The file NFI_INCEPTION_WEIGHTS names, or None when it is unset or
    names no file (FID is then off, as in the JAX package)."""
    path = os.environ.get("NFI_INCEPTION_WEIGHTS")
    return path if path and os.path.exists(path) else None


def load_fid_inception(path: str, device="cuda") -> torch.nn.Module:
    """FIDInceptionV3 on `device` with pytorch-fid's weights from `path`."""
    from nerf_from_image_tpu_torch.models.inception import FIDInceptionV3
    from nerf_from_image_tpu_torch.utils.weights import load_inception_weights

    model = FIDInceptionV3(device=device)
    model.load_state_dict(load_inception_weights(path), strict=True)
    return model


@torch.no_grad()
def compute_real_fid_stats(
    inception, images: np.ndarray, batch_size: int = 32,
    resolution: Optional[int] = None, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inception statistics (mu [D], sigma [D, D] on `device`, in
    metrics/fid.py's FID_DTYPE) of a real split's images [N, H, W, C] in
    [-1, 1] (host array). When the images are twice `resolution`, they
    are first averaged over 2x2 blocks, as the reference anti-aliases for
    a half-resolution evaluation."""
    dev = resolve_device(device)

    def prep(x):
        im = to_device(x[..., :3], dev) / 2.0 + 0.5
        if resolution is not None and im.shape[1] == 2 * resolution:
            B, H, W, C = im.shape
            im = im.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
        return im

    n = len(images)
    acts = [inception(prep(images[i : i + batch_size])) for i in range(0, n, batch_size)]
    return fid_mod.calculate_stats(torch.cat(acts).to(fid_mod.FID_DTYPE))


def _frechet(activations: torch.Tensor, real_stats) -> float:
    mu, sigma = fid_mod.calculate_stats(activations.to(fid_mod.FID_DTYPE))
    return float(fid_mod.frechet_distance(mu, sigma, real_stats[0], real_stats[1]))


def make_recon_eval_fn(render_config: RenderConfig, model, inception=None, lpips=None,
                       device="cuda"):
    """The evaluation batch of the training-time evaluate() modes:

        eval_batch(z, pose, focal, center=None, bbox=None, image_in=None,
                   target=None, label=None) -> dict

    renders z (through the mapping, conditioned on `image_in` [B, H, W, 3]
    or `label` [B] for a conditional generator) with no camera gradient,
    and returns 'rgb' [B, H, W, 3] (clipped to [-1, 1]), 'depth' and
    'mask'; with a `target` [B, H, W, 3 or 4], per-sample 'psnr', 'ssim',
    'lpips' (when `lpips` is given) and 'iou' (a fourth, mask channel);
    with `inception`, 'activations' [B, D]."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_batch(z, pose, focal, center=None, bbox=None, image_in=None, target=None,
                   label=None):
        out, _ = render(render_config, model, pose, focal, z, center=center, bbox=bbox,
                        image=image_in, label=label, force_no_cam_grad=True, device=dev)
        pred = torch.clamp(out.rgb[..., :3], -1.0, 1.0)
        res = {"rgb": pred, "depth": out.depth, "mask": out.mask}
        if target is not None:
            res["psnr"] = image_metrics.psnr(pred / 2 + 0.5, target[..., :3] / 2 + 0.5,
                                             reduction="none")
            res["ssim"] = image_metrics.ssim(pred / 2 + 0.5, target[..., :3] / 2 + 0.5,
                                             reduction="none")
            if lpips is not None:
                res["lpips"] = lpips(pred, target[..., :3]).reshape(-1)
            if target.shape[-1] > 3:
                res["iou"] = image_metrics.iou(out.mask, target[..., 3], reduction="none")
        if inception is not None:
            res["activations"] = inception(pred / 2 + 0.5)
        return res

    return eval_batch


def evaluate_recon(
    eval_batch_fn,
    z_fid: np.ndarray,
    split,
    eval_indices: np.ndarray,
    real_stats=None,
    batch_size: int = 32,
    recon_mode: Optional[str] = None,
    perm_indices: Optional[np.ndarray] = None,
    views_per_object: Optional[int] = None,
    input_images: Optional[np.ndarray] = None,
    use_labels: bool = False,
    device="cuda",
) -> Dict[str, object]:
    """The host loop of the training-time evaluate().

    recon_mode None renders z_fid at the evaluation poses (generation
    FID); 'front' renders at each evaluation image's own pose and scores
    against it; 'random' renders at the paired novel view (`perm_indices`)
    and scores only when the dataset has more than one view per object.
    `input_images` are the encoder's inputs (the uncropped train images),
    indexed by the original evaluation index.

    Returns the metrics' means, 'fid' when `real_stats` and activations
    are there, 'n_images', and 'first_batch': the first batch's 'rgb',
    'depth' and 'mask' as numpy arrays, for image grids. On several ranks
    each batch's rows are split over them (the last batch padded with its
    last image), and the rows are gathered in order, so every rank returns
    the one-rank result.
    """
    dev = resolve_device(device)
    n = len(eval_indices)
    pose_indices = perm_indices if recon_mode == "random" else eval_indices
    score = recon_mode == "front" or (
        recon_mode == "random" and views_per_object is not None and views_per_object > 1)
    world = mesh.world_size()

    acts = []
    sums: Dict[str, float] = {}
    count = 0
    first_batch = None
    for i in range(0, n, batch_size):
        rows = np.arange(i, min(i + batch_size, n))
        n_real = len(rows)
        if world > 1:
            rows = np.concatenate((rows, np.repeat(rows[-1:], (-n_real) % world)))
            rows = rows[mesh.row_block(len(rows))]
        sel = split.select(pose_indices[rows])
        target = to_device(sel.images, dev) if score and sel.images is not None else None
        image_in = None
        if input_images is not None:
            image_in = to_device(input_images[eval_indices[rows]][..., :3], dev)
        label = (to_device(sel.classes, dev, torch.long)
                 if use_labels and sel.classes is not None else None)
        res = eval_batch_fn(to_device(z_fid[rows], dev),
                            to_device(sel.tform_cam2world, dev), to_device(sel.focal_length, dev),
                            to_device(sel.center, dev), to_device(sel.bbox, dev), image_in, target,
                            label)
        if world > 1:
            keep = ("activations", "psnr", "ssim", "lpips", "iou") + (
                ("rgb", "depth", "mask") if first_batch is None else ())
            res = mesh.gather_rows({k: v.detach().cpu().numpy() for k, v in res.items()
                                    if k in keep})
            res = {k: torch.as_tensor(v[:n_real], device=dev) for k, v in res.items()}
        if "activations" in res:
            acts.append(res.pop("activations"))
        for k in ("psnr", "ssim", "lpips", "iou"):
            if k in res:
                sums[k] = sums.get(k, 0.0) + float(torch.sum(res[k]))
        count += n_real
        if first_batch is None:
            first_batch = {k: res[k].cpu().numpy() for k in ("rgb", "depth", "mask")
                           if k in res}

    out: Dict[str, object] = {k: v / max(count, 1) for k, v in sums.items()}
    if acts and real_stats is not None:
        out["fid"] = _frechet(torch.cat(acts), real_stats)
    out["n_images"] = count
    out["first_batch"] = first_batch
    return out
