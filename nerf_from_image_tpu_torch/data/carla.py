"""CARLA dataset: png renders + per-image extrinsics + shared intrinsics.

Re-design of the reference CARLA loader (reference: data/datasets.py:725-767,
data/loaders.py:463-501). This package's copy of the JAX package's
data/carla.py."""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from nerf_from_image_tpu_torch.data import image_ops
from nerf_from_image_tpu_torch.data.splits import DatasetSplit


def load_carla_split(
    dataset_path: str,
    image_size: int,
    highres: bool = False,
    max_images: Optional[int] = None,
) -> DatasetSplit:
    from nerf_from_image_tpu_torch.utils.images import read_image

    img_paths = sorted(glob.glob(os.path.join(dataset_path, "*.png")))
    if max_images is not None:
        img_paths = img_paths[:max_images]
    assert img_paths, f"no CARLA images under {dataset_path}"

    poses = []
    for p in img_paths:
        pose_path = os.path.join(
            dataset_path,
            "carla_poses",
            os.path.basename(p).replace(".png", "_extrinsics.npy"),
        )
        poses.append(np.load(pose_path))
    pose_mats = np.zeros((len(poses), 4, 4), np.float32)
    pose_mats[:, :3] = np.stack(poses)
    pose_mats[:, 3, 3] = 1

    intr = np.load(os.path.join(dataset_path, "carla_poses", "intrinsics.npy"))
    center = intr[0, 0, :2, 2].astype(np.float32)
    focal = float(intr[0, 0, 0, 0])

    target = image_size * (2 if highres else 1)
    images_hr = []
    original_res = None
    for p in img_paths:
        img = read_image(p)[..., :3].astype(np.float32) / 255 * 2 - 1
        if original_res is None:
            original_res = img.shape[0]
        images_hr.append(image_ops.resize_to(img, (target, target)))
    images_hr = np.stack(images_hr)

    images = (
        np.stack([image_ops.avg_pool2(im) for im in images_hr])
        if highres
        else images_hr
    )
    n = len(images)
    # The reference reads the intrinsics center only to assert it is
    # shared across samples and never wires it into the split
    # (data/loaders.py:472-478; DatasetSplit.center stays None) — rays are
    # generated with the default principal point. Passing the file's
    # center here would shift every CARLA ray vs the reference render.
    del center
    return DatasetSplit(
        images=images.astype(np.float32),
        images_highres=images_hr.astype(np.float32) if highres else None,
        tform_cam2world=pose_mats,
        focal_length=np.full((n,), focal / original_res, np.float32),
    )
