"""Synthetic driving datasets on disk, for the tests and chip_smoke.py.

`build_nusc_tree` writes a nuScenes-format tree (the JSON tables, CAM_FRONT
frames, LIDAR_TOP sweeps, Mask-RCNN instances and the valid-sample index)
and `build_kitti_tree` a KITTI or Waymo object-detection tree (images,
velodyne scans, calibration, labels, Mask-RCNN instances) whose frame and
objects are the first two valid samples of the package's own index, so
the readers' default index finds them. Cars, boxes, masks and LiDAR points
are consistent in 3D: the boxes and masks are the cars' projections and a
few hundred LiDAR returns lie just inside the faces each car turns to the
sensor. Sizes are parameters (the defaults are the datasets' cameras:
1600x900 nuScenes, 1242x375 KITTI, 1920x1280 Waymo); the cars stay where
they are in metres and the intrinsics scale with the image, so a smaller
tree is the same scene at a lower resolution. Images and masks are PNG
files written by utils/images.py: no imageio, cv2 or PIL is needed.

This is test support; no driver reads it.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Dict, List

import numpy as np

from nerf_from_image_tpu_torch.data.nusc_lite import quat_to_rot
from nerf_from_image_tpu_torch.utils import images

# nuScenes CAM_FRONT (v1.0-mini, scene-0061) and KITTI 000000's P2 at their
# native sizes; both scale with the written image.
NUSC_SIZE = (1600, 900)
NUSC_K = np.array([[1266.417, 0.0, 816.267], [0.0, 1266.417, 491.507], [0.0, 0.0, 1.0]])
KITTI_SIZE, WAYMO_SIZE = (1242, 375), (1920, 1280)
KITTI_CALIB = {
    "P2": [721.5377, 0.0, 609.5593, 44.85728, 0.0, 721.5377, 172.854, 0.2163791,
           0.0, 0.0, 1.0, 0.002745884],
    "R0_rect": [0.9999239, 0.00983776, -0.007445048, -0.0098698, 0.9999421,
                -0.004278459, 0.007402527, 0.004351614, 0.9999631],
    "Tr_velo_to_cam": [0.007533745, -0.9999714, -0.000616602, -0.004069766,
                       0.01480249, 0.0007280733, -0.9998902, -0.07631618,
                       0.9998621, 0.00752379, 0.0148556, -0.2717806],
}
COCO_CAR, COCO_PERSON = 2, 0


def write_filtered_png(path: str, img: np.ndarray, kinds) -> None:
    """Writes a uint8 or uint16 image ([H, W] gray, [H, W, C] with C in
    2-4) as a PNG whose row r uses filter kinds[r] (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth): files that exercise every path of a reader."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(img.astype(">u2" if depth == 16 else np.uint8))
    x = raw.view(np.uint8).reshape(h, w, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack((np.zeros_like(x), a, b, (a + b) >> 1, paeth))
    kinds = np.asarray(kinds, np.uint8)
    pred = preds[kinds.astype(np.int64), np.arange(h)]
    rows = np.concatenate((kinds[:, None], ((x - pred) & 255).astype(np.uint8).reshape(h, -1)),
                          axis=1)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(images._PNG_SIGNATURE + images._chunk(b"IHDR", header)
                + images._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + images._chunk(b"IEND", b""))


def _yaw_quat(yaw: float) -> List[float]:
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def _box_corners(center, wlh, rot) -> np.ndarray:
    """[3, 8] corners of a box (nuScenes corner order), its x along l."""
    w, l, h = wlh
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    return rot @ np.vstack((x, y, z)) + np.asarray(center, float)[:, None]


def _surface_points(rng, center, half, rot, eye, n, inset=0.96) -> np.ndarray:
    """n points just inside the faces of a box (half-extents `half` along
    its axes `rot`) that face the point `eye`: [n, 3]."""
    center, half = np.asarray(center, float), np.asarray(half, float)
    local_eye = rot.T @ (np.asarray(eye, float) - center)
    faces = [(axis, sign) for axis in range(3) for sign in (-1.0, 1.0)
             if sign * local_eye[axis] > half[axis]]
    pick = rng.integers(0, len(faces), n)
    pts = rng.uniform(-1.0, 1.0, (n, 3)) * half * inset
    for i, (axis, sign) in enumerate(faces):
        pts[pick == i, axis] = sign * half[axis] * inset
    return pts @ rot.T + center


def _ellipse_mask(h: int, w: int, box) -> np.ndarray:
    """uint8 [h, w]: 255 inside the ellipse inscribed in box (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = box
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    rx, ry = max((x1 - x0) / 2, 0.5), max((y1 - y0) / 2, 0.5)
    yy, xx = np.mgrid[:h, :w]
    inside = ((xx + 0.5 - cx) / rx) ** 2 + ((yy + 0.5 - cy) / ry) ** 2 <= 1.0
    return (inside * 255).astype(np.uint8)


def _frame(rng, h: int, w: int, boxes, colours) -> np.ndarray:
    """uint8 [h, w, 3]: sky over road, each box a painted car with noise."""
    yy = np.linspace(0.0, 1.0, h)[:, None, None]
    img = np.where(yy < 0.45, [140, 170, 210], [90, 90, 95]) * (0.8 + 0.2 * yy)
    img = np.broadcast_to(img, (h, w, 3)).astype(np.float64)
    for box, colour in zip(boxes, colours):
        inside = _ellipse_mask(h, w, box) > 0
        img[inside] = colour
    img += rng.normal(0.0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_instances(seg_dir: str, stem: str, h: int, w: int, boxes, classes,
                     label_schema: str) -> None:
    """Mask-RCNN dump: <stem>.json (boxes, scores and COCO 'classes' or
    string 'labels') and one <stem>_<i>.png mask per instance."""
    os.makedirs(seg_dir, exist_ok=True)
    for i, box in enumerate(boxes):
        images.write_png(os.path.join(seg_dir, f"{stem}_{i}.png"), _ellipse_mask(h, w, box))
    preds = {"boxes": [[float(v) for v in b] for b in boxes],
             "scores": [0.99 - 0.01 * i for i in range(len(boxes))]}
    if label_schema == "labels":
        preds["labels"] = ["car" if c == COCO_CAR else "person" for c in classes]
    else:
        preds["classes"] = [int(c) for c in classes]
    with open(os.path.join(seg_dir, stem + ".json"), "w") as f:
        json.dump(preds, f)


def _clip_box(pts_2d: np.ndarray, w: int, h: int):
    """[2, N] image points -> their bounding box clipped to the image."""
    return [float(np.clip(pts_2d[0].min(), 0, w - 1)), float(np.clip(pts_2d[1].min(), 0, h - 1)),
            float(np.clip(pts_2d[0].max(), 0, w - 1)), float(np.clip(pts_2d[1].max(), 0, h - 1))]


# Two cars in the first ego frame (x forward, y left, z up): a near one,
# ~450 px wide at 1600x900, and a far one, ~60 px wide.
_NUSC_CARS = (
    {"xy": (12.0, 2.0), "yaw": 0.5, "wlh": (1.9, 4.6, 1.6), "colour": (40, 60, 150)},
    {"xy": (80.0, -4.0), "yaw": 1.75, "wlh": (1.8, 4.3, 1.5), "colour": (150, 40, 40)},
)
# Ego poses (global xy, yaw) of the views; the second is 2 m back and
# turned 0.08 rad. The LiDAR sweep's ego pose is 0.1 m behind the camera's.
_NUSC_EGO = ((100.0, 50.0, 0.3),
             (100.0 - 2.0 * math.cos(0.3), 50.0 - 2.0 * math.sin(0.3), 0.38))


def build_nusc_tree(root: str, width: int = NUSC_SIZE[0], height: int = NUSC_SIZE[1],
                    lidar_points: int = 34000, views: int = 2, cars: int = 2,
                    label_schema: str = "classes", seed: int = 0) -> Dict[str, object]:
    """Writes a nuScenes v1.0-mini-format tree under `root` holding `cars`
    cars (at most 2), each annotated in `views` CAM_FRONT frames (at most
    2; 2 give the cross-view path), a person beside them, and returns
    {'version', 'index_file', 'frames': CAM_FRONT file names,
    'annotations': the index's valid samples}."""
    version = "v1.0-mini"
    rng = np.random.default_rng(seed)
    for d in (version, "samples/CAM_FRONT", "samples/LIDAR_TOP"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    sx, sy = width / NUSC_SIZE[0], height / NUSC_SIZE[1]
    K = NUSC_K * np.array([[sx], [sy], [1.0]])
    cam_t, cam_q = [1.70, 0.016, 1.51], [0.5, -0.5, 0.5, -0.5]  # z forward -> ego x
    lid_t, lid_q = [0.94, 0.0, 1.84], _yaw_quat(-math.pi / 2)
    tables = {
        "sensor": [{"token": "sen_cam", "channel": "CAM_FRONT", "modality": "camera"},
                   {"token": "sen_lid", "channel": "LIDAR_TOP", "modality": "lidar"}],
        "calibrated_sensor": [
            {"token": "cs_cam", "sensor_token": "sen_cam", "translation": cam_t,
             "rotation": cam_q, "camera_intrinsic": K.tolist()},
            {"token": "cs_lid", "sensor_token": "sen_lid", "translation": lid_t,
             "rotation": lid_q, "camera_intrinsic": []}],
        "ego_pose": [], "sample_data": [], "sample": [], "sample_annotation": [],
        "instance": [], "category": [{"token": "cat_car", "name": "vehicle.car"}],
    }
    # The cars in the global frame, placed from the first view's ego pose.
    ex, ey, eyaw = _NUSC_EGO[0]
    r0 = quat_to_rot(_yaw_quat(eyaw))
    car_boxes = []
    for i, car in enumerate(_NUSC_CARS[:cars]):
        centre = r0 @ np.array([car["xy"][0], car["xy"][1], car["wlh"][2] / 2]) + [ex, ey, 0.0]
        car_boxes.append((centre, car["wlh"], eyaw + car["yaw"]))
        tables["instance"].append({"token": f"ins{i}", "category_token": "cat_car"})
    valid, per_ins, ins_of, attr, frames = [], {f"ins{i}": [] for i in range(cars)}, {}, {}, []
    for v in range(views):
        gx, gy, gyaw = _NUSC_EGO[v]
        rot_e = quat_to_rot(_yaw_quat(gyaw))
        tables["ego_pose"] += [
            {"token": f"ep_cam{v}", "translation": [gx, gy, 0.0], "rotation": _yaw_quat(gyaw)},
            {"token": f"ep_lid{v}", "translation": list(rot_e @ [-0.1, 0.0, 0.0] + [gx, gy, 0.0]),
             "rotation": _yaw_quat(gyaw)}]
        name = f"n008-fixture__CAM_FRONT__{v:04d}.png"
        frames.append(name)
        tables["sample_data"] += [
            {"token": f"sd_cam{v}", "sample_token": f"s{v}", "calibrated_sensor_token": "cs_cam",
             "ego_pose_token": f"ep_cam{v}", "filename": f"samples/CAM_FRONT/{name}"},
            {"token": f"sd_lid{v}", "sample_token": f"s{v}", "calibrated_sensor_token": "cs_lid",
             "ego_pose_token": f"ep_lid{v}",
             "filename": f"samples/LIDAR_TOP/n008-fixture__LIDAR_TOP__{v:04d}.pcd.bin"}]
        tables["sample"].append({"token": f"s{v}", "data": {"CAM_FRONT": f"sd_cam{v}",
                                                            "LIDAR_TOP": f"sd_lid{v}"}})
        # Global -> camera for this view.
        r_c2e = quat_to_rot(cam_q)
        cam_pos = rot_e @ np.asarray(cam_t) + [gx, gy, 0.0]

        def to_cam(p, rot_e=rot_e, gx=gx, gy=gy):
            return r_c2e.T @ (rot_e.T @ (p - np.array([[gx], [gy], [0.0]])) - np.c_[cam_t])

        boxes_2d, classes, colours, lidar = [], [], [], []
        for i, (centre, wlh, yaw) in enumerate(car_boxes):
            rot = quat_to_rot(_yaw_quat(yaw))
            corners = to_cam(_box_corners(centre, wlh, rot))
            uvw = K @ corners
            boxes_2d.append(_clip_box(uvw[:2] / uvw[2:], width, height))
            classes.append(COCO_CAR)
            colours.append(_NUSC_CARS[i]["colour"])
            half = np.array([wlh[1], wlh[0], wlh[2]]) / 2
            lidar.append(_surface_points(rng, centre, half, rot, cam_pos, 300))
            ann = f"ann{i}_{v}"
            tables["sample_annotation"].append(
                {"token": ann, "sample_token": f"s{v}", "instance_token": f"ins{i}",
                 "translation": list(centre), "size": list(wlh), "rotation": _yaw_quat(yaw)})
            valid.append([ann, "CAM_FRONT"])
            per_ins[f"ins{i}"].append([ann, "CAM_FRONT"])
            ins_of[ann] = f"ins{i}"
            # Instance 1 of the Mask-RCNN dump is the person.
            attr[ann] = {"CAM_FRONT": {"seg_id": 0 if i == 0 else 2,
                                       "lidar_cnt": 300.0}}
        # A person between the cars: Mask-RCNN instance 1, not a car.
        person = [0.47 * width, 0.52 * height, 0.5 * width, 0.62 * height]
        boxes_2d.insert(1, person)
        classes.insert(1, COCO_PERSON)
        colours.insert(1, (200, 180, 40))
        images.write_png(os.path.join(root, "samples/CAM_FRONT", name),
                         _frame(rng, height, width, boxes_2d, colours))
        _write_instances(os.path.join(root, "pred_instance", "CAM_FRONT"), name[:-4],
                         height, width, boxes_2d, classes, label_schema)
        # The sweep: ground, the cars' returns and far walls, in the LiDAR
        # sensor's frame at its own ego pose.
        n_bg = lidar_points - sum(len(p) for p in lidar)
        n_ground = n_bg * 3 // 4
        ground = np.c_[rng.uniform(-60, 80, n_ground), rng.uniform(-40, 40, n_ground),
                       np.zeros(n_ground)]
        walls = np.c_[rng.uniform(-60, 80, n_bg - n_ground),
                      rng.choice([-25.0, 25.0], n_bg - n_ground),
                      rng.uniform(0, 8, n_bg - n_ground)]
        ego_pts = np.concatenate((ground, walls))
        ego_pose = tables["ego_pose"][-1]
        glob = np.concatenate((rot_e @ ego_pts.T + np.c_[ego_pose["translation"]],
                               np.concatenate(lidar).T), axis=1)
        local = quat_to_rot(lid_q).T @ (rot_e.T @ (glob - np.c_[ego_pose["translation"]])
                                         - np.c_[lid_t])
        pts = np.zeros((local.shape[1], 5), np.float32)
        pts[:, :3] = local.T
        pts[:, 3] = rng.uniform(0, 100, len(pts))
        pts[:, 4] = rng.integers(0, 32, len(pts))
        pts.tofile(os.path.join(root, tables["sample_data"][-1]["filename"]))
    for table, rows in tables.items():
        with open(os.path.join(root, version, f"{table}.json"), "w") as f:
            json.dump(rows, f)
    index = {"all_valid_samples": valid, "instoken_per_ann": ins_of,
             "anntokens_per_ins": per_ins, "sample_attr": attr}
    index_file = os.path.join(root, version, "index.json")
    with open(index_file, "w") as f:
        json.dump(index, f)
    return {"version": version, "index_file": index_file, "frames": frames,
            "annotations": valid}


def use_jpeg_frame(root: str, tree: Dict[str, object]) -> Dict[str, object]:
    """Replaces the first CAM_FRONT frame of a tree that build_nusc_tree
    wrote at the camera's 1600x900 with its default seed by the committed
    JPEG of that frame (data/jpeg/, written by PIL at quality 75, 4:2:0),
    as real nuScenes frames are JPEG. Returns `tree` with the frame's new
    name."""
    import shutil

    from nerf_from_image_tpu_torch.data.jpeg import FIXTURE_DIR
    from nerf_from_image_tpu_torch.data.jpeg.make_fixtures import CAM_FRONT_FRAME

    old = tree["frames"][0]
    png = os.path.join(root, "samples/CAM_FRONT", old)
    if images.image_shape(png) != (NUSC_SIZE[1], NUSC_SIZE[0]) or old[:-4] != CAM_FRONT_FRAME[:-4]:
        raise ValueError(f"{png} is not the default tree's first 1600x900 frame")
    shutil.copyfile(os.path.join(FIXTURE_DIR, CAM_FRONT_FRAME),
                    os.path.join(root, "samples/CAM_FRONT", CAM_FRONT_FRAME))
    os.remove(png)
    table = os.path.join(root, tree["version"], "sample_data.json")
    with open(table) as f:
        rows = json.load(f)
    for row in rows:
        if row["filename"] == f"samples/CAM_FRONT/{old}":
            row["filename"] = f"samples/CAM_FRONT/{CAM_FRONT_FRAME}"
    with open(table, "w") as f:
        json.dump(rows, f)
    return dict(tree, frames=[CAM_FRONT_FRAME] + list(tree["frames"][1:]))


# The two KITTI cars in the rectified camera frame: (x, y of the box's
# bottom, z), heading ry, (h, w, l); a near one ~400 px wide at 1242x375
# and a far one ~60 px wide.
_KITTI_CARS = (
    {"t": (-2.6, 1.65, 8.5), "ry": -1.2, "hwl": (1.5, 1.6, 3.9), "colour": (40, 60, 150)},
    {"t": (4.0, 1.7, 42.0), "ry": 0.3, "hwl": (1.45, 1.7, 4.1), "colour": (150, 40, 40)},
)


def build_kitti_tree(root: str, is_waymo: bool = False, width: int = 0, height: int = 0,
                     lidar_points: int = 120000, seed: int = 0) -> Dict[str, object]:
    """Writes a KITTI (or, with is_waymo, a Waymo-as-KITTI) object tree
    under `root` for the first two valid samples of the package's index
    (data/index/kitti.val.Car.json or waymo.val_small.Car.json): one frame
    with those two cars at their label lines and Mask-RCNN instance ids,
    DontCare lines and other instances elsewhere. width/height default to
    the dataset's camera. Returns {'split', 'frame', 'objects'}."""
    default = WAYMO_SIZE if is_waymo else KITTI_SIZE
    width, height = width or default[0], height or default[1]
    name = "waymo.val_small.Car.json" if is_waymo else "kitti.val.Car.json"
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "index", name)) as f:
        index = json.load(f)
    (frame, obj_a), (frame_b, obj_b) = index["all_valid_samples"][:2]
    assert frame == frame_b, "the index's first two samples share a frame"
    seg = {int(o): index["sample_attr"][frame][o]["seg_id"] for o in (obj_a, obj_b)}
    split = "validation" if is_waymo else "training"
    img_dir, lbl_dir = ("image", "label") if is_waymo else ("image_2", "label_2")
    base = os.path.join(root, split)
    for d in (img_dir, lbl_dir, "calib", "velodyne", "pred_instance"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    rng = np.random.default_rng(seed)

    sx, sy = width / KITTI_SIZE[0], height / KITTI_SIZE[1]
    P = np.asarray(KITTI_CALIB["P2"]).reshape(3, 4) * np.array([[sx], [sy], [1.0]])
    calib = dict(KITTI_CALIB, P2=P.reshape(-1).tolist())
    with open(os.path.join(base, "calib", f"{frame}.txt"), "w") as f:
        for key in ("P0", "P1", "P2", "P3"):
            f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in calib["P2"]) + "\n")
        f.write("R0_rect: " + " ".join(f"{v:.12e}" for v in calib["R0_rect"]) + "\n")
        f.write("Tr_velo_to_cam: " + " ".join(f"{v:.12e}" for v in calib["Tr_velo_to_cam"])
                + "\n")
        f.write("Tr_imu_to_velo: " + " ".join(["0.0"] * 12) + "\n")
    R0 = np.asarray(KITTI_CALIB["R0_rect"]).reshape(3, 3)
    V2C = np.asarray(KITTI_CALIB["Tr_velo_to_cam"]).reshape(3, 4)

    n_lines = max(int(obj_a), int(obj_b)) + 1
    lines = ["DontCare -1 -1 -10 0.00 0.00 1.00 1.00 -1 -1 -1 -1000 -1000 -1000 -10"] * n_lines
    n_inst = max(seg.values()) + 1
    inst_boxes = [[0.02 * width + 0.03 * width * i, 0.55 * height,
                   0.04 * width + 0.03 * width * i, 0.75 * height] for i in range(n_inst)]
    classes, colours = [COCO_PERSON] * n_inst, [(200, 180, 40)] * n_inst
    car_pts = []
    for car, obj in zip(_KITTI_CARS, (int(obj_a), int(obj_b))):
        h, w, l = car["hwl"]
        c, s = math.cos(car["ry"]), math.sin(car["ry"])
        roty = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
        y = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
        z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
        corners = roty @ np.stack([x, y, z]) + np.asarray(car["t"])[:, None]
        uvw = P @ np.vstack((corners, np.ones(8)))
        box = _clip_box(uvw[:2] / uvw[2:], width, height)
        alpha = car["ry"] - math.atan2(car["t"][0], car["t"][2])
        lines[obj] = ("Car 0.00 0 {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} "
                      "{:.2f} {:.2f} {:.2f} {:.2f}").format(
            alpha, *box, h, w, l, *car["t"], car["ry"])
        inst_boxes[seg[obj]], classes[seg[obj]] = box, COCO_CAR
        colours[seg[obj]] = car["colour"]
        centre = np.asarray(car["t"]) - [0.0, h / 2, 0.0]
        rect = _surface_points(rng, centre, np.array([l, h, w]) / 2, roty, np.zeros(3), 400)
        car_pts.append(rect)
    with open(os.path.join(base, lbl_dir, f"{frame}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    images.write_png(os.path.join(base, img_dir, f"{frame}.png"),
                     _frame(rng, height, width, inst_boxes, colours))
    _write_instances(os.path.join(base, "pred_instance"), frame, height, width, inst_boxes,
                     classes, "classes")
    # The scan in the velodyne frame: ground 1.73 m below the sensor, walls,
    # and the cars' returns (rect -> ref -> velo).
    rect = np.concatenate(car_pts)
    ref = rect @ np.linalg.inv(R0).T
    velo_cars = (ref - V2C[:, 3]) @ V2C[:, :3]
    n_bg = lidar_points - len(velo_cars)
    n_ground = n_bg * 3 // 4
    ground = np.c_[rng.uniform(-40, 70, n_ground), rng.uniform(-40, 40, n_ground),
                   np.full(n_ground, -1.73)]
    walls = np.c_[rng.uniform(-40, 70, n_bg - n_ground), rng.choice([-15.0, 15.0], n_bg - n_ground),
                  rng.uniform(-1.7, 4.0, n_bg - n_ground)]
    scan = np.zeros((lidar_points, 4), np.float32)
    scan[:, :3] = np.concatenate((ground, walls, velo_cars))
    scan[:, 3] = rng.uniform(0, 1, lidar_points)
    scan.tofile(os.path.join(base, "velodyne", f"{frame}.bin"))
    return {"split": split, "frame": frame, "objects": [obj_a, obj_b]}
