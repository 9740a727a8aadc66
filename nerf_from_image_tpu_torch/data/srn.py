"""SRN ShapeNet dataset (cars/chairs) loader.

Re-design of the reference SRN pipeline (reference: data/datasets.py:574-722
SRNDataset + data/loaders.py:400-460 load_shapenet): per-object directories
with intrinsics.txt, rgb/*.png and pose/*.txt (cam2world, multiplied by
diag(1, -1, -1, 1)); images normalized to [-1, 1]; shared focal normalized
by image size. Loads straight into a DatasetSplit (no torch DataLoader
indirection — plain multiprocessing-free numpy, the dataset fits in RAM).
This package's copy of the JAX package's data/srn.py.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from nerf_from_image_tpu_torch.data import image_ops
from nerf_from_image_tpu_torch.data.splits import DatasetSplit

_COORD_TRANS = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _load_object(intrin_path: str, image_size: int, limit=None, rng=None):
    from nerf_from_image_tpu_torch.utils.images import read_image

    dir_path = os.path.dirname(intrin_path)
    rgb_paths = sorted(glob.glob(os.path.join(dir_path, "rgb", "*")))
    pose_paths = sorted(glob.glob(os.path.join(dir_path, "pose", "*")))
    assert len(rgb_paths) == len(pose_paths)

    with open(intrin_path) as f:
        lines = f.readlines()
        focal, cx, cy, _ = map(float, lines[0].split())

    if limit is not None:
        indices = (rng or np.random).choice(
            len(rgb_paths), size=(limit,), replace=False
        )
        rgb_paths = [rgb_paths[i] for i in indices]
        pose_paths = [pose_paths[i] for i in indices]

    imgs = []
    poses = []
    for rgb_path, pose_path in zip(rgb_paths, pose_paths):
        img = read_image(rgb_path)[..., :3].astype(np.float32) / 255.0
        pose = np.loadtxt(pose_path, dtype=np.float32).reshape(4, 4)
        poses.append(pose @ _COORD_TRANS)
        imgs.append(img)
    imgs = np.stack(imgs)

    src_res = imgs.shape[1]
    if src_res != image_size:
        scale = image_size / src_res
        focal *= scale
        cx *= scale
        cy *= scale
        imgs = np.stack(
            [image_ops.resize_to(im, (image_size, image_size)) for im in imgs]
        )
    imgs = imgs * 2.0 - 1.0
    return (
        imgs.astype(np.float32),
        np.stack(poses),
        focal / image_size,
        np.array([cx, cy], np.float32) / image_size,
    )


def load_srn_split(
    path: str,
    stage: str,
    image_size: int = 128,
    limit_views: Optional[int] = None,
    max_objects: Optional[int] = None,
) -> DatasetSplit:
    """Loads shapenet_<cat>_<stage> into a DatasetSplit."""
    base_path = f"{path}_{stage}"
    name = os.path.basename(path)
    if "chair" in name and stage == "train":
        tmp = os.path.join(base_path, "chairs_2.0_train")
        if os.path.exists(tmp):
            base_path = tmp
    intrins = sorted(glob.glob(os.path.join(base_path, "*", "intrinsics.txt")))
    if max_objects is not None:
        intrins = intrins[:max_objects]
    assert intrins, f"no SRN objects under {base_path}"

    rng = np.random.RandomState(1234)
    all_imgs, all_poses, all_centers = [], [], []
    focal = None
    for ip in intrins:
        imgs, poses, f, c = _load_object(ip, image_size, limit_views, rng)
        if focal is None:
            focal = f
        all_imgs.append(imgs)
        all_poses.append(poses)
        # Per-object principal point, normalized to [0, 1] like
        # get_ray_bundle's `center` argument. The reference loads it per
        # object and asserts uniformity (data/loaders.py:428-429); we keep
        # it per image so off-center SRN intrinsics render correctly.
        all_centers.append(np.broadcast_to(c, (len(imgs), 2)))

    images = np.concatenate(all_imgs)
    return DatasetSplit(
        images=images,
        tform_cam2world=np.concatenate(all_poses),
        focal_length=np.full((len(images),), focal, np.float32),
        center=np.ascontiguousarray(np.concatenate(all_centers)),
    )
