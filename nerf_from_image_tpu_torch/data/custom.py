"""P3D / ImageNet / CUB single-view collections (CMR-style annotations).

Re-design of the reference CustomDataset / CUBDataset (reference:
data/datasets.py:40-571): detections.npy + COCO RLE masks + estimated SfM
poses (.bin) for p3d/imagenet; CMR .mat annotations with ortho SfM poses for
CUB. The crop / square-bbox / mirror / normalized-bbox pipeline and the
pose-matrix assembly (perspective f=1+exp(z0) remap, CUB ortho scale with
z-offset 10, y/z flip, inversion to cam2world) are preserved exactly.

Pure numpy; COCO masks decode through data/coco_mask (no pycocotools
dependency). torch is only needed to read the reference's .bin pose files
(torch.load) — a numpy fallback handles .npz exports of the same content.
This package's copy of the JAX package's data/custom.py.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from nerf_from_image_tpu_torch.data import coco_mask, image_ops


def quaternion_to_matrix4(quaternion: np.ndarray) -> np.ndarray:
    """transformations.py-style (w, x, y, z) quaternion -> 4x4 (reference:
    data/datasets.py:144-160)."""
    q = np.array(quaternion, dtype=np.float64, copy=True)
    n = np.dot(q, q)
    eps = np.finfo(float).eps * 4.0
    if n < eps:
        return np.identity(4)
    q *= np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array(
        [
            [1 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0],
            [q[1, 2] + q[3, 0], 1 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1 - q[1, 1] - q[2, 2], 0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def _read_image(path: str) -> np.ndarray:
    from nerf_from_image_tpu_torch.utils.images import read_image

    img = read_image(path) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def _flip_pose_matrix(M: np.ndarray) -> np.ndarray:
    flip = np.eye(4)
    flip[1, 1] = flip[2, 2] = -1
    return np.linalg.inv(flip @ M)


class CustomCollection:
    """p3d_<cat> / imagenet_<cat> detections + estimated poses."""

    PADDING_FRAC = 0.05

    def __init__(self, dataset: str, split: str, img_size: int, root_dir: str,
                 crop: bool = False, add_mirrored: bool = False):
        self.img_size = img_size
        self.crop = crop
        self.add_mirrored = add_mirrored
        self.root_dir = root_dir

        if "imagenet" in dataset:
            assert split in ("train",), "ImageNet has no test split"
            det_path = os.path.join(root_dir, "imagenet", dataset,
                                    "detections.npy")
            poses_path = os.path.join(
                root_dir, "imagenet", dataset,
                "poses_estimated_multitpl_perspective.bin",
            )
        else:
            det_path = os.path.join(root_dir, "p3d", dataset, "detections.npy")
            poses_path = os.path.join(
                root_dir, "p3d", dataset,
                "poses_estimated_singletpl_perspective.bin",
            )

        if split == "test":
            self._init_p3d_test(root_dir)
            return

        self.detections = np.load(det_path, allow_pickle=True)

        valid_indices = None
        if split == "imagenet_test":
            # ImageNet-car images not present in the p3d train set, evaluated
            # with the multi-template poses (reference:
            # data/datasets.py:101-130, --inv_use_imagenet_testset).
            aux_dataset = dataset.replace("p3d", "imagenet")
            aux_dir = os.path.join(root_dir, "imagenet", aux_dataset)
            detections_aux = np.load(
                os.path.join(aux_dir, "detections.npy"), allow_pickle=True
            )
            poses_path = os.path.join(
                aux_dir, "poses_estimated_multitpl_perspective.bin"
            )
            train_names = {
                os.path.basename(str(item["image_path"]))
                for item in self.detections
            }
            valid_indices = np.array(
                [
                    os.path.basename(str(item["image_path"]))
                    not in train_names
                    for item in detections_aux
                ]
            )
            self.detections = detections_aux

        poses = self._load_poses(poses_path)
        self.detections = self.detections[poses["indices"]]
        if valid_indices is not None:
            valid_indices = valid_indices[poses["indices"]]
            self.detections = self.detections[valid_indices]
            poses = {k: v[valid_indices] for k, v in poses.items()}
        # Perspective remap (reference: data/datasets.py:131-139).
        f = 1.0 + np.exp(poses["z0"])
        t = np.concatenate(
            (poses["t"] / poses["s"], f / poses["s"]), axis=-1
        )
        self.poses = {"f": f, "t": t, "R": poses["R"]}

    @staticmethod
    def _load_poses(path: str) -> Dict[str, np.ndarray]:
        if path.endswith(".npz") or os.path.exists(path + ".npz"):
            data = np.load(path if path.endswith(".npz") else path + ".npz")
            return {k: np.asarray(data[k]) for k in data.files}
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        return {
            k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in data.items()
        }

    def _init_p3d_test(self, root_dir: str):
        import scipy.io

        anno_path = os.path.join(
            root_dir, "p3d", "p3d_sfm_image", "img_anno", "car_val.mat"
        )
        val_images = scipy.io.loadmat(
            anno_path, struct_as_record=False, squeeze_me=True
        )["images"]
        self.detections = []
        for img in val_images:
            self.detections.append(
                {
                    "image_path": os.path.join(
                        "p3d", "PASCAL3D+_release1.1", "Images",
                        str(img.rel_path).replace("\\", "/"),
                    ),
                    "bbox": np.array(
                        [img.bbox.x1, img.bbox.y1, img.bbox.x2, img.bbox.y2],
                        float,
                    )
                    - 1,
                    "mask_raw": np.asfortranarray(img.mask),
                }
            )
        n = len(val_images)
        self.poses = {
            "f": np.zeros((n, 1), np.float32),
            "t": np.zeros((n, 3), np.float32),
            "R": np.zeros((n, 4), np.float32),
        }

    def __len__(self):
        return (2 if self.add_mirrored else 1) * len(self.detections)

    def _decode_mask(self, item) -> np.ndarray:
        if "mask_raw" in item:
            return np.asarray(item["mask_raw"], np.uint8)
        return coco_mask.decode(item["mask"])

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        idx_ = idx
        mirrored = False
        if self.add_mirrored and idx >= len(self.detections):
            idx_ = idx - len(self.detections)
            mirrored = True
        item = self.detections[idx_]

        img_path = os.path.join(
            self.root_dir, str(item["image_path"]).replace("datasets/", "")
        )
        img = _read_image(img_path)
        mask = self._decode_mask(item)[..., None].astype(np.float64)
        bbox = np.asarray(item["bbox"], float).flatten()

        sfm_pose = [
            np.asarray(self.poses["f"][idx_]).copy(),
            np.asarray(self.poses["t"][idx_]).copy(),
            np.asarray(self.poses["R"][idx_]).copy(),
        ]

        if mirrored:
            img = img[:, ::-1, :].copy()
            mask = mask[:, ::-1].copy()
            sfm_pose[2] = sfm_pose[2] * np.array([1, 1, -1, -1])
            sfm_pose[1] = sfm_pose[1] * np.array([-1, 1, 1])
            bbox = image_ops.mirror_bbox(bbox, img.shape[1])

        if self.crop:
            bbox = image_ops.perturb_bbox(bbox, pf=self.PADDING_FRAC)
        else:
            bbox = [0, 0, img.shape[1] - 1, img.shape[0] - 1]
        bbox = image_ops.square_bbox(bbox)
        nbbox = image_ops.normalized_bbox(bbox, img.shape[0], img.shape[1])

        img_c = image_ops.crop_padded(img, bbox, bgval=1)
        mask_c = image_ops.crop_padded(mask, bbox, bgval=0)
        scale = self.img_size / float(max(img_c.shape[0], img_c.shape[1]))
        img_r, _ = image_ops.resize_area(img_c, scale)
        mask_r, _ = image_ops.resize_area(mask_c, scale)

        M = quaternion_to_matrix4(sfm_pose[2])
        M[:3, 3] += sfm_pose[1]
        focal = np.asarray(sfm_pose[0]).reshape(-1)[:1] / 2
        M = _flip_pose_matrix(M)

        mask_out = mask_r[..., 0] if mask_r.ndim == 3 else mask_r
        img_out = (img_r * 2 - 1) * mask_out[..., None]
        img_out = np.concatenate((img_out, mask_out[..., None]), axis=-1)
        return {
            "img": img_out.astype(np.float32),
            "normalized_bbox": nbbox.astype(np.float32),
            "focal": focal.astype(np.float32),
            "pose": M.astype(np.float32),
            "mirrored": mirrored,
            "class": -1,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self.sample(i)


class CUBCollection(CustomCollection):
    """CUB-200-2011 with CMR annotations and orthographic SfM poses."""

    def __init__(self, split: str, img_size: int, root_dir: str,
                 crop: bool = False, add_mirrored: bool = False):
        import scipy.io

        self.img_size = img_size
        self.crop = crop
        self.add_mirrored = add_mirrored
        self.root_dir = root_dir
        self.data_dir = os.path.join(root_dir, "cub", "CUB_200_2011")
        self.img_dir = os.path.join(self.data_dir, "images")
        anno_path = os.path.join(
            root_dir, "cub", "data", f"{split}_cub_cleaned.mat"
        )
        anno_sfm_path = os.path.join(root_dir, "cub", "sfm",
                                     f"anno_{split}.mat")
        self.anno = scipy.io.loadmat(
            anno_path, struct_as_record=False, squeeze_me=True
        )["images"]
        self.anno_sfm = scipy.io.loadmat(
            anno_sfm_path, struct_as_record=False, squeeze_me=True
        )["sfm_anno"]

        with open(os.path.join(self.data_dir, "images.txt")) as f:
            ids = {k: v.strip() for k, v in (x.split(" ") for x in f)}
        with open(
            os.path.join(self.data_dir, "image_class_labels.txt")
        ) as f:
            classes = {
                k: int(v.strip()) - 1 for k, v in (x.split(" ") for x in f)
            }
        self.filename_to_class = {ids[k]: c for k, c in classes.items()}

    def __len__(self):
        return (2 if self.add_mirrored else 1) * len(self.anno)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        idx_ = idx
        mirrored = False
        if self.add_mirrored and idx >= len(self.anno):
            idx_ = idx - len(self.anno)
            mirrored = True
        data = self.anno[idx_]
        data_sfm = self.anno_sfm[idx_]

        # Ortho SfM pose: scale, 2D translation, 3x3 rotation -> quaternion.
        sfm_rot = np.pad(np.copy(data_sfm.rot), (0, 1), "constant")
        sfm_rot[3, 3] = 1
        # Reference uses lib/pose_utils.matrix_to_quaternion (numpy);
        # reproduce via this package's vectorized version on the 4x4.
        import torch

        from nerf_from_image_tpu_torch.pose.pose import matrix_to_quaternion

        quat = matrix_to_quaternion(
            torch.as_tensor(sfm_rot[None], dtype=torch.float32)
        )[0].numpy()
        sfm_pose = [
            np.copy(data_sfm.scale).astype(np.float64),
            np.copy(data_sfm.trans).astype(np.float64),
            quat.astype(np.float64),
        ]

        rel_path = str(data.rel_path).replace("\\", "/")
        img = _read_image(os.path.join(self.img_dir, rel_path))
        mask = np.expand_dims(data.mask, 2).astype(np.float64)
        class_label = self.filename_to_class[rel_path]

        bbox = (
            np.array(
                [data.bbox.x1, data.bbox.y1, data.bbox.x2, data.bbox.y2],
                float,
            )
            - 1
        )
        if self.crop:
            bbox = image_ops.perturb_bbox(bbox, pf=self.PADDING_FRAC)
        else:
            bbox = [0, 0, img.shape[1] - 1, img.shape[0] - 1]
        bbox = image_ops.square_bbox(bbox)

        # Crop translates the SfM screen translation.
        img_c = image_ops.crop_padded(img, bbox, bgval=1)
        mask_c = image_ops.crop_padded(mask, bbox, bgval=0)
        sfm_pose[1][0] -= bbox[0]
        sfm_pose[1][1] -= bbox[1]

        scale = self.img_size / float(max(img_c.shape[0], img_c.shape[1]))
        img_r, _ = image_ops.resize_area(img_c, scale)
        mask_r, _ = image_ops.resize_area(mask_c, scale)
        sfm_pose[0] *= scale
        sfm_pose[1] *= scale

        img_h, img_w = img_r.shape[:2]
        sfm_pose[0] *= 1.0 / img_w + 1.0 / img_h
        sfm_pose[1][0] = 2.0 * (sfm_pose[1][0] / img_w) - 1
        sfm_pose[1][1] = 2.0 * (sfm_pose[1][1] / img_h) - 1

        if mirrored:
            img_r = img_r[:, ::-1, :].copy()
            mask_r = mask_r[:, ::-1].copy()
            sfm_pose[2] = sfm_pose[2] * np.array([1, 1, -1, -1])
            sfm_pose[1][0] *= -1

        # Ortho pose matrix with fixed z-offset 10 (reference:
        # data/datasets.py:556-566).
        M = quaternion_to_matrix4(sfm_pose[2])
        M[:3, :3] *= sfm_pose[0]
        M[3, 3] *= sfm_pose[0]
        M[:2, 3] += sfm_pose[1]
        M[2, 3] += 10
        M[:3, 3] *= sfm_pose[0]
        M = _flip_pose_matrix(M)

        mask_out = mask_r[..., 0] if mask_r.ndim == 3 else mask_r
        img_out = (img_r * 2 - 1) * mask_out[..., None]
        img_out = np.concatenate((img_out, mask_out[..., None]), axis=-1)
        return {
            "img": img_out.astype(np.float32),
            "normalized_bbox": np.zeros((2, 2), np.float32),
            "focal": np.zeros((1,), np.float32),
            "pose": M.astype(np.float32),
            "mirrored": mirrored,
            "class": class_label,
        }
