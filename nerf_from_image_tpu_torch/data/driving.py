"""Driving-dataset plumbing shared by the nuScenes/KITTI/Waymo evaluations.

Re-design of the reference's driving data layer (reference:
data/datasets.py:770-1433 NuScenes/Kitti/WaymoDataset, data/kitti_util.py
Calibration, lib/utils.py:195-266 box geometry + frame fixes): 3D-box point
selection, occlusion-aware masks from Mask-RCNN instances, LiDAR sparse depth
maps, the per-object square-crop + intrinsics renormalization pipeline, and
the KITTI calibration chain (velo -> ref -> rect -> image). This package's
copy of the JAX package's data/driving.py, numpy only: PNG images and masks
are decoded by utils/images.py and the resizes are data/image_ops.py's
numpy versions of cv2's, so no cv2, imageio or PIL is needed for PNG data.
No devkit dependencies (the nuScenes DB is read directly from its JSON
tables in data/nusc_lite.py).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from nerf_from_image_tpu_torch.data import image_ops
from nerf_from_image_tpu_torch.utils.images import read_image

# Frame change applied to driving cam2world poses before rendering
# (reference: eval_nusc_persp.py:1129-1136).
NUSC2SHAPENET = np.array(
    [[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
)


def pts_in_box_3d(pts_3d: np.ndarray, corners_3d: np.ndarray,
                  keep_top_portion: float = 1.0) -> np.ndarray:
    """Boolean mask of points inside an oriented 3D box given its 8 corners
    ([3, 8], nusc ordering). reference: lib/utils.py:195-218."""
    v1 = corners_3d[:, 1:2] - corners_3d[:, 0:1]
    v2 = (corners_3d[:, 3:4] - corners_3d[:, 0:1]) * keep_top_portion
    v3 = corners_3d[:, 4:5] - corners_3d[:, 0:1]
    v_test = pts_3d - corners_3d[:, 0:1]
    proj_1 = v1.T @ v_test
    proj_2 = v2.T @ v_test
    proj_3 = v3.T @ v_test
    s1 = np.logical_and(proj_1 > 0, proj_1 < v1.T @ v1)
    s2 = np.logical_and(proj_2 > 0, proj_2 < v2.T @ v2)
    s3 = np.logical_and(proj_3 > 0, proj_3 < v3.T @ v3)
    return np.squeeze(np.logical_and(s1, np.logical_and(s2, s3)))


def corners_of_box(obj_pose: np.ndarray, wlh, is_kitti: bool = False):
    """3D box corners [3, 8] from a [3, 4] object pose and (w, l, h)
    (reference: lib/utils.py:221-252; KITTI boxes sit on the ground)."""
    w, l, h = wlh
    if is_kitti:
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = h / 2 * np.array([-2, -2, 0, 0, -2, -2, 0, 0])
        z = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    else:
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    corners = obj_pose[:, :3] @ np.vstack((x, y, z))
    return corners + obj_pose[:, 3:4]


def obj_pose_kitti2nusc(obj_pose: np.ndarray, obj_h: float) -> np.ndarray:
    """KITTI object frame (x-front, y-down, z-left; origin on the ground) ->
    nuScenes convention (reference: lib/utils.py:254-266). [3, 4] -> [3, 4]."""
    out = obj_pose.copy()
    out[1, 3] -= obj_h / 2
    r_x = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]], obj_pose.dtype)
    out[:, :3] = out[:, :3] @ r_x
    return out


def get_mask_occ_from_ins(masks: List[np.ndarray], tgt_ins_id: int):
    """Occlusion-aware mask: 1 = target, -1 = background, 0 = occluder
    (reference: data/datasets.py:813-827)."""
    tgt = masks[tgt_ins_id]
    occ = np.zeros_like(tgt, np.int32)
    union = np.sum(np.asarray(masks), axis=0)
    occ[union == 0] = -1
    occ[tgt > 0] = 1
    return occ


def load_instance_masks(seg_dir: str, stem: str):
    """Mask-RCNN predictions: <stem>.json + <stem>_<i>.png instance masks."""
    with open(os.path.join(seg_dir, stem + ".json")) as f:
        preds = json.load(f)
    masks = [
        read_image(os.path.join(seg_dir, f"{stem}_{i}.png"))
        for i in range(len(preds["boxes"]))
    ]
    return preds, masks


def crop_for_inversion(
    img: np.ndarray,
    mask_occ: np.ndarray,
    depth_map: Optional[np.ndarray],
    box_2d,
    K: np.ndarray,
    img_size: int,
    white_bkgd: bool,
) -> Dict[str, np.ndarray]:
    """Square crop + intrinsics renormalization for per-object inversion
    (reference: data/datasets.py:930-988 — identical across the three
    datasets). The mask and depth take cv2's INTER_NEAREST, the image its
    INTER_AREA (data/image_ops.py)."""
    bbox = image_ops.square_bbox(box_2d)
    K = K.copy().astype(np.float64)

    img = img.astype(np.float32) / 255.0
    img_c = image_ops.crop_padded(img, bbox, bgval=1)
    mask = (mask_occ > 0).astype(np.float32)[:, :, None]
    mask_c = image_ops.crop_padded(mask, bbox, bgval=0)
    depth_c = None
    if depth_map is not None:
        depth_c = image_ops.crop_padded(
            depth_map[:, :, None], bbox, bgval=-1
        )
    K[0, 2] -= (bbox[0] + bbox[2]) / 2
    K[1, 2] -= (bbox[1] + bbox[3]) / 2

    bheight, bwidth = img_c.shape[:2]
    scale = img_size / float(max(bwidth, bheight))
    img_r, _ = image_ops.resize_area(img_c, scale)
    mask_r = image_ops.resize_nearest(mask_c, (img_size, img_size))[..., 0]
    depth_r = None
    if depth_c is not None:
        depth_r = image_ops.resize_nearest(depth_c, (img_size, img_size))[..., 0]
    K[0, :] /= float(max(bwidth, bheight))
    K[1, :] /= float(max(bwidth, bheight))

    img_out = np.transpose(img_r, (2, 0, 1))
    mask_out = mask_r[None, :, :]
    if white_bkgd:
        img_out = img_out * mask_out
        img_out = img_out - (mask_out - 1)
        img_out = img_out * 2 - 1
    else:  # grey background
        img_out = img_out * 2 - 1
        img_out = img_out * mask_out
    out = {
        "img": np.transpose(img_out, (1, 2, 0)).astype(np.float32),
        "mask": mask_r.astype(np.float32),
        "bbox": np.asarray(bbox, np.float32),
        "K": K.astype(np.float32),
    }
    if depth_r is not None:
        out["depth"] = depth_r.astype(np.float32)
    return out


class KittiCalibration:
    """KITTI calib file: P2 / R0_rect / Tr_velo_to_cam projections
    (reference: data/kitti_util.py:113-262)."""

    def __init__(self, calib_filepath: str):
        data = {}
        with open(calib_filepath) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                key, value = line.split(":", 1)
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        self.P = data["P2"].reshape(3, 4)
        self.V2C = data["Tr_velo_to_cam"].reshape(3, 4)
        self.R0 = data["R0_rect"].reshape(3, 3)
        # cam->velo inverse rigid transform (reference kitti_util.py:364).
        self.C2V = np.zeros_like(self.V2C)
        self.C2V[:3, :3] = self.V2C[:3, :3].T
        self.C2V[:3, 3] = -self.V2C[:3, :3].T @ self.V2C[:3, 3]
        # Intrinsics decomposition (reference kitti_util.py:163-169): the
        # P2 translation column encodes the stereo baseline offset b_x/b_y
        # used by image->rect back-projection.
        self.c_u, self.c_v = self.P[0, 2], self.P[1, 2]
        self.f_u, self.f_v = self.P[0, 0], self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @staticmethod
    def _hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1))))

    # 3d <-> 3d (reference kitti_util.py:220-247)
    def project_velo_to_ref(self, pts_velo: np.ndarray) -> np.ndarray:
        return self._hom(pts_velo) @ self.V2C.T

    def project_ref_to_velo(self, pts_ref: np.ndarray) -> np.ndarray:
        return self._hom(pts_ref) @ self.C2V.T

    def project_ref_to_rect(self, pts_ref: np.ndarray) -> np.ndarray:
        return pts_ref @ self.R0.T

    def project_rect_to_ref(self, pts_rect: np.ndarray) -> np.ndarray:
        return pts_rect @ np.linalg.inv(self.R0).T

    def project_velo_to_rect(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_ref_to_rect(self.project_velo_to_ref(pts_velo))

    def project_rect_to_velo(self, pts_rect: np.ndarray) -> np.ndarray:
        return self.project_ref_to_velo(self.project_rect_to_ref(pts_rect))

    # 3d -> 2d (reference kitti_util.py:250-285)
    def project_rect_to_image(self, pts_rect: np.ndarray) -> np.ndarray:
        p = self._hom(pts_rect) @ self.P.T
        return p[:, :2] / p[:, 2:3]

    def project_velo_to_image(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))

    @staticmethod
    def project_8p_to_4p(pts_2d: np.ndarray) -> np.ndarray:
        """8 projected box corners -> [x0, y0, x1, y1] image AABB (x0/y0
        clamped at 0; reference kitti_util.py:267-276)."""
        x0, y0 = np.min(pts_2d, axis=0)
        x1, y1 = np.max(pts_2d, axis=0)
        return np.array([max(0.0, x0), max(0.0, y0), x1, y1])

    def project_velo_to_4p(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_8p_to_4p(self.project_velo_to_image(pts_velo))

    # 2d -> 3d (reference kitti_util.py:288-326)
    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """[N,3] (u, v, rect depth) -> [N,3] rect-frame points."""
        z = uv_depth[:, 2]
        x = (uv_depth[:, 0] - self.c_u) * z / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * z / self.f_v + self.b_y
        return np.stack([x, y, z], axis=1)

    def project_image_to_velo(self, uv_depth: np.ndarray) -> np.ndarray:
        return self.project_rect_to_velo(self.project_image_to_rect(uv_depth))

    def project_depth_to_velo(
        self, depth: np.ndarray, constraint_box: bool = True
    ) -> np.ndarray:
        """Dense [H,W] rect-depth map -> velo-frame point cloud, optionally
        clipped to the reference's scene box (kitti_util.py:306-326)."""
        vv, uu = np.nonzero(np.ones_like(depth, dtype=bool))
        uvd = np.stack([uu, vv, depth[vv, uu]], axis=1).astype(np.float64)
        pc = self.project_image_to_velo(uvd)
        if constraint_box:
            lo = np.array([0.0, -40.0, -3.0])
            hi = np.array([70.4, 40.0, 2.0])
            pc = pc[np.all((pc >= lo) & (pc < hi), axis=1)]
        return pc


def lidar_in_image_fov(pc_velo, calib: KittiCalibration, width, height,
                       clip_distance: float = 2.0):
    """LiDAR points inside the image frustum (reference:
    data/kitti_object.py get_lidar_in_image_fov semantics)."""
    pts_2d = calib.project_rect_to_image(calib.project_velo_to_rect(pc_velo))
    fov = (
        (pts_2d[:, 0] < width)
        & (pts_2d[:, 0] >= 0)
        & (pts_2d[:, 1] < height)
        & (pts_2d[:, 1] >= 0)
        & (pc_velo[:, 0] > clip_distance)
    )
    return pc_velo[fov], pts_2d, fov


@dataclasses.dataclass
class KittiLabel:
    type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray  # [4]
    h: float
    w: float
    l: float  # noqa: E741
    t: Tuple[float, float, float]
    ry: float

    @classmethod
    def parse(cls, line: str) -> "KittiLabel":
        d = line.split()
        return cls(
            type=d[0],
            truncation=float(d[1]),
            occlusion=int(float(d[2])),
            alpha=float(d[3]),
            box2d=np.array([float(x) for x in d[4:8]]),
            h=float(d[8]),
            w=float(d[9]),
            l=float(d[10]),
            t=(float(d[11]), float(d[12]), float(d[13])),
            ry=float(d[14]),
        )


class KittiObjectReader:
    """KITTI object-detection layout reader (reference: data/kitti_object.py).

    <root>/<split>/{image_2, label_2, calib, velodyne, pred_instance}
    """

    def __init__(self, root: str, split: str = "training",
                 is_waymo: bool = False):
        self.split_dir = os.path.join(root, split)
        # Waymo-as-KITTI exports use image/ and label/ instead of the
        # KITTI image_2/ and label_2/ (reference: data/waymo_object.py:54-55
        # vs data/kitti_object.py:54-55).
        self.image_dir = "image" if is_waymo else "image_2"
        self.label_dir = "label" if is_waymo else "label_2"

    def image(self, idx) -> np.ndarray:
        path = os.path.join(
            self.split_dir, self.image_dir, f"{int(idx):06d}.png"
        )
        return read_image(path)[..., :3]

    def lidar(self, idx) -> np.ndarray:
        path = os.path.join(self.split_dir, "velodyne", f"{int(idx):06d}.bin")
        return np.fromfile(path, np.float32).reshape(-1, 4)

    def calib(self, idx) -> KittiCalibration:
        return KittiCalibration(
            os.path.join(self.split_dir, "calib", f"{int(idx):06d}.txt")
        )

    def labels(self, idx) -> List[KittiLabel]:
        path = os.path.join(
            self.split_dir, self.label_dir, f"{int(idx):06d}.txt"
        )
        with open(path) as f:
            return [KittiLabel.parse(line) for line in f if line.strip()]


class KittiDrivingDataset:
    """Per-object KITTI samples for vehicle inversion (reference:
    data/datasets.py:1085-1263)."""

    def __init__(self, kitti_data_dir: str, img_size: int = 128,
                 white_bkgd: bool = False, split: str = "training",
                 index_file: Optional[str] = None,
                 is_waymo: bool = False):
        self.reader = KittiObjectReader(
            kitti_data_dir, split, is_waymo=is_waymo
        )
        self.seg_dir = os.path.join(kitti_data_dir, split, "pred_instance")
        self.img_size = img_size
        self.white_bkgd = white_bkgd
        self.is_waymo = is_waymo
        if index_file is None:
            name = "waymo.val_small.Car.json" if is_waymo else "kitti.val.Car.json"
            index_file = os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "index", name
            )
        with open(index_file) as f:
            subset = json.load(f)
        self.all_valid_samples = subset["all_valid_samples"]
        self.sample_attr = subset["sample_attr"]

    def __len__(self):
        return len(self.all_valid_samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        data_idx, obj_idx = self.all_valid_samples[idx]
        pc_velo = self.reader.lidar(int(data_idx))[:, :4]
        calib = self.reader.calib(int(data_idx))
        img = self.reader.image(int(data_idx))
        objects = self.reader.labels(int(data_idx))
        h, w = img.shape[:2]
        K = calib.P[:, :3]
        obj = objects[int(obj_idx)]

        box_2d = obj.box2d
        ry = obj.ry
        Ry = np.array(
            [
                [np.cos(ry), 0.0, np.sin(ry)],
                [0.0, 1.0, 0.0],
                [-np.sin(ry), 0.0, np.cos(ry)],
            ],
            np.float32,
        )
        T_obj = np.asarray(obj.t).reshape(3, 1) + np.linalg.inv(K) @ calib.P[:, 3:]
        obj_pose = np.concatenate([Ry, T_obj], axis=1)
        # KITTI object frame (y-down, origin on the ground) -> nuScenes
        # convention BEFORE inverting to the camera-in-object pose: the
        # render-frame remap downstream (NUSC2SHAPENET) assumes the
        # nuScenes object frame (reference: eval_kitti_persp.py:957
        # applies obj_pose_kitti2nusc to the GT world2cam).
        obj_pose_nusc = obj_pose_kitti2nusc(obj_pose, obj.h)
        R_c2o = obj_pose_nusc[:, :3].T
        t_c2o = -R_c2o @ obj_pose_nusc[:, 3:]
        cam_pose = np.concatenate([R_c2o, t_c2o], axis=1)
        wlh = np.array([obj.w, obj.l, obj.h])
        corners_3d = corners_of_box(obj_pose, wlh, is_kitti=True)

        preds, ins_masks = load_instance_masks(self.seg_dir, str(data_idx))
        tgt_ins_id = self.sample_attr[data_idx][obj_idx]["seg_id"]
        mask_occ = get_mask_occ_from_ins(ins_masks, tgt_ins_id)

        fov_velo, pts_2d, fov = lidar_in_image_fov(pc_velo[:, :3], calib, w, h)
        lidar_im = pts_2d[fov].T
        rect = calib.project_velo_to_rect(fov_velo).T
        depth = rect[2, :]
        inside = pts_in_box_3d(rect, corners_3d, keep_top_portion=0.9)
        depth_map = np.zeros(img.shape[:2], np.float32)
        depth_map[
            lidar_im[1, inside].astype(np.int32),
            lidar_im[0, inside].astype(np.int32),
        ] = depth[inside]

        sample = crop_for_inversion(
            img, mask_occ, depth_map, box_2d, K, self.img_size,
            self.white_bkgd,
        )
        sample.update(
            cam_pose=cam_pose.astype(np.float32),
            obj_pose=obj_pose.astype(np.float32),
            wlh=wlh.astype(np.float32),
            occlusion=obj.occlusion,
            data_idx=data_idx,
            obj_idx=obj_idx,
        )
        return sample
