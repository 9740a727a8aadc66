"""Minimal devkit-free nuScenes reader.

Replaces the nuscenes-devkit dependency of the reference driving eval
(reference: data/datasets.py:770-1082 uses NuScenes, view_points,
BoxVisibility, map_pointcloud_to_image). The nuScenes DB is plain JSON
tables; this module loads the handful the vehicle-inversion pipeline needs
(sample, sample_data, sample_annotation, calibrated_sensor, ego_pose,
instance, category) and reimplements the transform chain global -> ego ->
sensor, box corner geometry, and LiDAR-to-image projection in numpy. This
package's copy of the JAX package's data/nusc_lite.py: images are read by
utils/images.py (PNG decoded in numpy, other formats through imageio), and
the LiDAR projection reads only the camera image's header for its size.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from nerf_from_image_tpu_torch.utils.images import image_shape, read_image


def quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def view_points(points: np.ndarray, view: np.ndarray, normalize: bool):
    """Projects [3, N] points with a 3x3 intrinsic (devkit-compatible)."""
    viewpad = np.eye(4)
    viewpad[: view.shape[0], : view.shape[1]] = view
    pts = np.concatenate((points, np.ones((1, points.shape[1]))))
    pts = viewpad @ pts
    pts = pts[:3]
    if normalize:
        pts = pts / pts[2:3]
    return pts


class Box:
    """Annotation box with pose arithmetic (devkit Box equivalent)."""

    def __init__(self, center, size, rotation_quat):
        self.center = np.asarray(center, float)
        self.wlh = np.asarray(size, float)
        self.rotation_matrix = quat_to_rot(rotation_quat)

    @property
    def orientation(self):
        return self

    def translate(self, t):
        self.center = self.center + t

    def rotate_by_matrix(self, r):
        self.rotation_matrix = r @ self.rotation_matrix
        self.center = r @ self.center

    def corners(self) -> np.ndarray:
        """[3, 8] corners, nusc ordering (x fwd, y left, z up)."""
        w, l, h = self.wlh
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = self.rotation_matrix @ np.vstack((x, y, z))
        return corners + self.center[:, None]


class NuScenesLite:
    TABLES = (
        "sample",
        "sample_data",
        "sample_annotation",
        "calibrated_sensor",
        "ego_pose",
        "instance",
        "category",
        "sensor",
    )

    def __init__(self, version: str, dataroot: str):
        self.version = version
        self.dataroot = dataroot
        table_dir = os.path.join(dataroot, version)
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in self.TABLES:
            with open(os.path.join(table_dir, f"{name}.json")) as f:
                rows = json.load(f)
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
        # Devkit shortcut parity (nuscenes.py __make_reverse_index__):
        # sample_data records gain 'channel' / 'sensor_modality' derived
        # through the calibrated_sensor -> sensor join. demo_driving's
        # frame lookup and instance-mask directory selection depend on it.
        for sd in self._tables["sample_data"]:
            cs = self._index["calibrated_sensor"].get(
                sd.get("calibrated_sensor_token", "")
            )
            sensor = (
                self._index["sensor"].get(cs.get("sensor_token", ""))
                if cs
                else None
            )
            if sensor is not None:
                sd.setdefault("channel", sensor["channel"])
                sd.setdefault("sensor_modality", sensor.get("modality"))

    @property
    def sample_data(self):
        return self._tables["sample_data"]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def get_box(self, ann_token: str) -> Box:
        ann = self.get("sample_annotation", ann_token)
        return Box(ann["translation"], ann["size"], ann["rotation"])

    def box_in_sensor_frame(self, ann_token: str, sd_token: str) -> Box:
        """Global-frame annotation -> sensor frame of the given sample_data
        (the devkit's get_sample_data box path)."""
        sd = self.get("sample_data", sd_token)
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ego = self.get("ego_pose", sd["ego_pose_token"])

        box = self.get_box(ann_token)
        # Global -> ego.
        box.translate(-np.asarray(ego["translation"]))
        box.rotate_by_matrix(quat_to_rot(ego["rotation"]).T)
        # Ego -> sensor.
        box.translate(-np.asarray(cs["translation"]))
        box.rotate_by_matrix(quat_to_rot(cs["rotation"]).T)
        return box

    def get_sample_data(
        self, sd_token: str, selected_anntokens: Optional[List[str]] = None
    ):
        """(data_path, boxes-in-sensor-frame, camera intrinsic [3,3])."""
        sd = self.get("sample_data", sd_token)
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        intrinsic = np.asarray(cs["camera_intrinsic"], float)
        data_path = os.path.join(self.dataroot, sd["filename"])
        boxes = []
        if selected_anntokens:
            for tok in selected_anntokens:
                boxes.append(self.box_in_sensor_frame(tok, sd_token))
        return data_path, boxes, intrinsic

    def map_pointcloud_to_image(
        self, pointsensor_token: str, camera_token: str, min_dist: float = 1.0
    ):
        """LiDAR points projected into the camera image.

        Returns (points [3, N] homogeneous image coords, depths [N]) for
        points in front of the camera and inside the image (the devkit's
        map_pointcloud_to_image semantics).
        """
        ps = self.get("sample_data", pointsensor_token)
        cam = self.get("sample_data", camera_token)

        pc = np.fromfile(
            os.path.join(self.dataroot, ps["filename"]), np.float32
        ).reshape(-1, 5)[:, :3].T  # [3, N]

        # LiDAR sensor -> ego (at lidar timestamp).
        cs = self.get("calibrated_sensor", ps["calibrated_sensor_token"])
        pc = quat_to_rot(cs["rotation"]) @ pc
        pc = pc + np.asarray(cs["translation"])[:, None]
        # Ego -> global.
        ep = self.get("ego_pose", ps["ego_pose_token"])
        pc = quat_to_rot(ep["rotation"]) @ pc
        pc = pc + np.asarray(ep["translation"])[:, None]
        # Global -> ego (at camera timestamp).
        ep_c = self.get("ego_pose", cam["ego_pose_token"])
        pc = pc - np.asarray(ep_c["translation"])[:, None]
        pc = quat_to_rot(ep_c["rotation"]).T @ pc
        # Ego -> camera sensor.
        cs_c = self.get("calibrated_sensor", cam["calibrated_sensor_token"])
        pc = pc - np.asarray(cs_c["translation"])[:, None]
        pc = quat_to_rot(cs_c["rotation"]).T @ pc

        depths = pc[2, :]
        intrinsic = np.asarray(cs_c["camera_intrinsic"], float)
        points = view_points(pc, intrinsic, normalize=True)

        # sample_data records carry the image dimensions; without them the
        # image file's header gives them (no pixels are decoded).
        w, h = cam.get("width"), cam.get("height")
        if not w or not h:
            h, w = image_shape(os.path.join(self.dataroot, cam["filename"]))
        mask = (
            (depths > min_dist)
            & (points[0] > 1)
            & (points[0] < w - 1)
            & (points[1] > 1)
            & (points[1] < h - 1)
        )
        return points[:, mask], depths[mask]


class NuScenesDrivingDataset:
    """Per-annotation nuScenes vehicle samples (reference:
    data/datasets.py:770-988), devkit-free."""

    def __init__(self, nusc_data_dir: str, nusc_version: str,
                 split: str = "val", img_size: int = 128,
                 white_bkgd: bool = False,
                 index_file: Optional[str] = None,
                 external_pose_file: Optional[str] = None):
        from nerf_from_image_tpu_torch.data.driving import (
            crop_for_inversion,
            get_mask_occ_from_ins,
            load_instance_masks,
            pts_in_box_3d,
        )

        self._crop = crop_for_inversion
        self._mask_occ = get_mask_occ_from_ins
        self._load_masks = load_instance_masks
        self._pts_in_box = pts_in_box_3d

        self.nusc = NuScenesLite(nusc_version, nusc_data_dir)
        self.seg_dir = os.path.join(nusc_data_dir, "pred_instance")
        self.img_size = img_size
        self.white_bkgd = white_bkgd
        if index_file is None:
            index_file = os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "index",
                f"nusc.{nusc_version}.{split}.vehicle.car.json",
            )
        with open(index_file) as f:
            subset = json.load(f)
        self.all_valid_samples = subset["all_valid_samples"]
        self.instoken_per_ann = subset["instoken_per_ann"]
        self.anntokens_per_ins = subset["anntokens_per_ins"]
        self.sample_attr = subset["sample_attr"]

        # Externally estimated poses (e.g. SUP-NeRF codes+poses.pth with an
        # 'optimized_poses'[anntoken][cam] entry holding [init, refined]
        # world2cam [3, 4] poses; reference: data/datasets.py:809-811,
        # eval_nusc_persp.py:1171-1175).
        self.optimized_poses = None
        if external_pose_file is not None and os.path.exists(
                external_pose_file):
            import torch

            saved = torch.load(external_pose_file, map_location="cpu")
            self.optimized_poses = saved["optimized_poses"]

    def __len__(self):
        return len(self.all_valid_samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        anntoken, cam = self.all_valid_samples[idx]
        ann = self.nusc.get("sample_annotation", anntoken)
        sample_record = self.nusc.get("sample", ann["sample_token"])

        data_path, boxes, K = self.nusc.get_sample_data(
            sample_record["data"][cam], selected_anntokens=[anntoken]
        )
        img = read_image(data_path)[..., :3]
        box = boxes[0]

        obj_pose = np.concatenate(
            [box.rotation_matrix, box.center[:, None]], axis=1
        )
        R_c2o = box.rotation_matrix.T
        t_c2o = -R_c2o @ box.center[:, None]
        cam_pose = np.concatenate([R_c2o, t_c2o], axis=1)

        corners = view_points(box.corners(), K, normalize=True)[:2]
        box_2d = [corners[0].min(), corners[1].min(), corners[0].max(),
                  corners[1].max()]

        stem = os.path.basename(data_path)[:-4]
        preds, ins_masks = self._load_masks(
            os.path.join(self.seg_dir, cam), stem
        )
        tgt_ins_id = self.sample_attr[anntoken][cam]["seg_id"]
        mask_occ = self._mask_occ(ins_masks, tgt_ins_id)

        pts_im, pts_depth = self.nusc.map_pointcloud_to_image(
            sample_record["data"]["LIDAR_TOP"], sample_record["data"][cam]
        )
        pts_cam = np.linalg.inv(K) @ pts_im * pts_depth
        inside = self._pts_in_box(pts_cam, box.corners(),
                                  keep_top_portion=0.9)
        depth_map = np.zeros(img.shape[:2], np.float32)
        depth_map[
            pts_im[1, inside].astype(np.int32),
            pts_im[0, inside].astype(np.int32),
        ] = pts_depth[inside]

        sample = self._crop(
            img, mask_occ, depth_map, box_2d, K, self.img_size,
            self.white_bkgd,
        )
        sample.update(
            cam_pose=cam_pose.astype(np.float32),
            obj_pose=obj_pose.astype(np.float32),
            wlh=np.asarray(ann["size"], np.float32),
            anntoken=anntoken,
            instoken=self.instoken_per_ann[anntoken],
            cam=cam,
        )
        if self.optimized_poses is not None:
            ext = np.asarray(self.optimized_poses[anntoken][cam],
                             dtype=np.float32)
            # [init, refined] pair; the eval consumes the refined pose
            # (reference: eval_nusc_persp.py:1171 indexes [0, 1]).
            sample["obj_pose_ext"] = ext[1] if ext.ndim == 3 else ext
        return sample
