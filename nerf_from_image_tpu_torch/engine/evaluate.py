"""Inversion evaluation: per-checkpoint metrics and the consolidated report.

Counterpart of nerf_from_image_tpu/engine/evaluate.py. At each checkpoint
step the recovered (w, pose) is rendered from the front view (and from
the paired novel view when one is given), and PSNR, SSIM, IoU, LPIPS and
the rotation error are taken per sample, without gradients; with an
Inception model, the front and novel views' activations too, from which
the report's summary takes fid_front and fid_random against real
statistics. The report is a host-side dict of numpy arrays written as
.npz plus a .txt summary, in the JAX package's format: a report saved by
either package loads in the other.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch.engine.inversion import (
    InversionConfig,
    PoseParams,
    build_camera,
)
from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.metrics import fid as fid_mod
from nerf_from_image_tpu_torch.metrics import image as image_metrics
from nerf_from_image_tpu_torch.parallel import mesh
from nerf_from_image_tpu_torch.pose.pose import rotation_matrix_distance
from nerf_from_image_tpu_torch.utils import fileio, trace
from nerf_from_image_tpu_torch.utils.device import check_on_device, resolve_device

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
        with trace.span("eval.metrics"):
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
            with trace.span("eval.metrics"):
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


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class InversionReport:
    """Accumulates per-checkpoint metric batches and writes the
    consolidated report (.npz arrays and a .txt summary)."""

    def __init__(self, checkpoint_steps, metric_notes=None):
        self.checkpoint_steps = list(checkpoint_steps)
        self.items: Dict[int, Dict[str, list]] = {
            step: {} for step in self.checkpoint_steps
        }
        # Metric prefix -> note appended to its summary lines, e.g.
        # {"lpips": "(RANDOM-FEATURE — not metric grade)"} when LPIPS runs
        # without pretrained weights.
        self.metric_notes: Dict[str, str] = dict(metric_notes or {})

    def merge_notes_on_resume(self, current_notes: Dict[str, str]) -> None:
        """Reconciles the saved metric notes with the resuming run's.

        Keeps the stricter (present) stamp both ways: rows accumulated
        under a note keep it even if the environment improved on resume,
        and metric-grade rows are marked as mixed when the resuming run
        adds a note (or drops one), so no row's provenance is upgraded.
        """
        for pfx, note in current_notes.items():
            old = self.metric_notes.get(pfx)
            if old and old != note:
                note = f"{old} + resumed with {note}"
            elif not old:
                note = f"{note} (mixed: metric-grade rows before resume)"
            self.metric_notes[pfx] = note
        for pfx, old in list(self.metric_notes.items()):
            if pfx not in current_notes and "resumed" not in old:
                self.metric_notes[pfx] = f"{old} (mixed: resumed at metric grade)"

    def add(self, step: int, metrics: Dict[str, Any], recovered=None):
        """Appends a batch of per-sample metrics (tensors or arrays) and,
        optionally, the recovered parameters to checkpoint `step`."""
        item = self.items[step]
        for k, v in metrics.items():
            item.setdefault(k, []).append(_to_numpy(v))
        if recovered is not None:
            for k, v in recovered.items():
                if v is not None:
                    item.setdefault(k, []).append(_to_numpy(v))

    def gathered(self) -> "InversionReport":
        """The report of every rank's rows, in rank order, on every rank
        (itself on one rank)."""
        if mesh.world_size() == 1:
            return self
        merged = InversionReport(self.checkpoint_steps, self.metric_notes)
        for part in mesh.gather_objects(self.consolidated()):
            for step, item in part.items():
                for k, v in item.items():
                    merged.items[step].setdefault(k, []).append(v)
        return merged

    def consolidated(self) -> Dict[int, Dict[str, np.ndarray]]:
        return {
            step: {
                k: np.concatenate(v) if np.ndim(v[0]) > 0 else np.asarray(v)
                for k, v in item.items()
            }
            for step, item in self.items.items()
        }

    def summary(self, fid_stats_real=None) -> str:
        """One line per metric and checkpoint: its mean, with its note; with
        the real statistics (mu, sigma), fid_front and fid_random of each
        checkpoint's accumulated activations (two images or more), computed
        in metrics/fid.py's FID_DTYPE where the statistics lie (tensors on
        the card: there)."""
        real = None
        if fid_stats_real is not None:
            real = [torch.as_tensor(s).to(fid_mod.FID_DTYPE) for s in fid_stats_real]
        lines = []
        for step, item in self.consolidated().items():
            lines.append(f"[checkpoint step {step}]")
            for k, v in sorted(item.items()):
                if k.startswith("inception_") or k in ("ws", "z0", "R", "s", "t2"):
                    continue
                note = next(
                    (f" {n}" for pfx, n in self.metric_notes.items()
                     if k == pfx or k.startswith(pfx + "_")),
                    "",
                )
                lines.append(f"  {k}: {float(np.mean(v)):.5f}{note}")
            if real is not None:
                for which in ("front", "random"):
                    key = f"inception_activations_{which}"
                    if key in item and len(item[key]) > 1:
                        mu, sigma = fid_mod.calculate_stats(torch.as_tensor(
                            np.asarray(item[key]), dtype=fid_mod.FID_DTYPE,
                            device=real[0].device))
                        fid_val = float(fid_mod.frechet_distance(mu, sigma, *real))
                        lines.append(f"  fid_{which}: {fid_val:.5f}")
        return "\n".join(lines)

    def save(self, path_prefix: str, fid_stats_real=None):
        """Writes <path_prefix>.npz (keys 'step<N>/<metric>', and
        '__metric_notes__' as JSON) and <path_prefix>.txt. The .npz is
        written to a temporary file first and moved over the old one, so
        a crash leaves the previous report whole; on rank 0 alone, the other
        ranks of a data-parallel run waiting for it. Returns the summary."""
        summary = self.summary(fid_stats_real)
        if mesh.is_main():
            self._write(path_prefix, summary)
        mesh.barrier()
        return summary

    def _write(self, path_prefix: str, summary: str) -> None:
        fileio.mkdir(os.path.dirname(path_prefix) or ".")
        flat = {}
        for step, item in self.consolidated().items():
            for k, v in item.items():
                flat[f"step{step}/{k}"] = v
        if self.metric_notes:
            flat["__metric_notes__"] = np.asarray(json.dumps(self.metric_notes))
        tmp = path_prefix + ".tmp.npz"  # np.savez appends .npz otherwise
        with fileio.open_file(tmp, "wb") as f:
            np.savez(f, **flat)
        fileio.replace_file(tmp, path_prefix + ".npz")
        with fileio.open_file(path_prefix + ".txt", "w") as f:
            f.write(summary + "\n")

    def num_samples(self, metric: str = "psnr") -> int:
        """Images accumulated so far at the first checkpoint (the resume
        cursor)."""
        step0 = self.items[self.checkpoint_steps[0]]
        if metric not in step0:
            return 0
        return int(sum(np.size(v) for v in step0[metric]))

    @classmethod
    def load(cls, path_prefix: str) -> "InversionReport":
        """Rebuilds a report from its saved .npz (local or gs://)."""
        with fileio.open_file(path_prefix + ".npz", "rb") as f:
            # Buffered whole: np.load reads the zip lazily.
            data = np.load(io.BytesIO(f.read()))
        steps = sorted(
            {int(k.split("/", 1)[0][len("step"):]) for k in data.files if "/" in k}
        )
        report = cls(steps)
        for key in data.files:
            if key == "__metric_notes__":
                report.metric_notes = json.loads(str(data[key]))
                continue
            step_str, metric = key.split("/", 1)
            report.items[int(step_str[len("step"):])].setdefault(metric, []).append(
                data[key])
        return report
