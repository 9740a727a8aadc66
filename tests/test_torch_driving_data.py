"""The port's driving data layer against the JAX package's, and its numpy
image code against the libraries it replaces.

- data/image_ops.py's resizes against cv2 (INTER_AREA, INTER_LINEAR,
  INTER_NEAREST) on float32 images of 1, 3 and 4 channels at integer and
  non-integer scales both ways: nearest exactly, area and linear within
  1e-6 absolute on [0, 1] data (float32 sums in another order).
- utils/images.py's PNG reader against imageio on files imageio writes and
  on files that use each of the five row filters (exact), its writer, its
  header-only image size, and the imageio fallback for other files.
- NuScenesDrivingDataset and KittiDrivingDataset (KITTI and Waymo layouts)
  against the JAX readers on the same trees (data/driving_fixtures.py):
  `img` within 1e-6 (the area resize), mask, depth, K and cam_pose equal;
  the external-pose file; reproject_depth equal on random geometry; the
  devkit helpers on tests/test_driving.py::TestDevkit's cases equal; the
  index JSONs byte-equal to the JAX package's.
"""

import filecmp
import os
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import eval_driving as jax_eval_driving
from nerf_from_image_tpu.data import devkit as jdevkit
from nerf_from_image_tpu.data import driving as jdriving
from nerf_from_image_tpu.data import nusc_lite as jnusc
from nerf_from_image_tpu_torch import eval_driving
from nerf_from_image_tpu_torch.data import devkit, driving, driving_fixtures, image_ops
from nerf_from_image_tpu_torch.data import nusc_lite
from nerf_from_image_tpu_torch.utils import images
from tests import test_driving
from tests.test_torch_generator import release_memory  # noqa: F401

RESIZE_ATOL = 1e-6
# (source, destination) sizes: integer and non-integer shrinks and
# enlargements, and one axis each way.
RESIZES = [((64, 48), (32, 24)), ((90, 61), (37, 25)), ((16, 12), (48, 36)),
           ((23, 17), (57, 40)), ((45, 80), (128, 30)), ((128, 128), (128, 128))]
CV2_FLAGS = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("mode", ["area", "linear", "nearest"])
def test_resizes_match_cv2(mode, channels):
    rng = np.random.default_rng(channels)
    for (h, w), (dh, dw) in RESIZES:
        img = rng.random((h, w, channels)).astype(np.float32)
        want = cv2.resize(img, (dw, dh), interpolation=CV2_FLAGS[mode]).reshape(dh, dw, channels)
        if mode == "nearest":
            got = image_ops.resize_nearest(img, (dh, dw))
            np.testing.assert_array_equal(got, want)
        else:
            got = image_ops.resize_to(img, (dh, dw), area=mode == "area")
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL,
                                       err_msg=f"{(h, w)} -> {(dh, dw)}")
        assert got.shape == (dh, dw, channels)


def test_resize_area_by_factor_matches_the_jax_package():
    """resize_area's size rounding and returned factors, and a 2-D image,
    against the JAX package's cv2 resize_area."""
    from nerf_from_image_tpu.data import image_ops as jimage_ops

    rng = np.random.default_rng(0)
    for shape, scale in (((45, 45, 3), 128 / 45), ((411, 411, 1), 128 / 411), ((37, 53), 0.5)):
        img = rng.random(shape).astype(np.float32)
        got, got_f = image_ops.resize_area(img, scale)
        want, want_f = jimage_ops.resize_area(img, scale)
        assert got.shape == want.shape and got_f == want_f
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    with pytest.raises(TypeError):
        image_ops.resize_to(np.zeros((4, 4), np.uint8), (2, 2))


def _image(rng, kind, h=29, w=37):
    smooth = (np.add.outer(np.sin(np.arange(h) / 4.0), np.cos(np.arange(w) / 6.0)) + 2) / 4
    if kind == "gray16":
        return (smooth * 60000 + rng.integers(0, 500, (h, w))).astype(np.uint16)
    channels = {"gray": 1, "gray_alpha": 2, "rgb": 3, "rgba": 4}[kind]
    img = smooth[..., None] * 200 + rng.integers(0, 50, (h, w, channels))
    return np.squeeze(img.astype(np.uint8), -1) if channels == 1 else img.astype(np.uint8)


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba", "gray16"])
def test_png_reader_matches_imageio(kind, tmp_path):
    """Files imageio writes (its encoder picks row filters adaptively)."""
    img = _image(np.random.default_rng(1), kind)
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, img)
    got, want = images.read_png(path), imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(images.read_image(path), want)
    assert images.image_shape(path) == want.shape[:2]


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reader_decodes_every_row_filter(filters, tmp_path):
    """Files whose rows use one filter, or all five in turn (then both
    decode paths: rows only of None/Sub/Up, and the anti-diagonal one)."""
    rng = np.random.default_rng(2)
    for kind in ("gray", "rgb", "rgba", "gray16"):
        img = _image(rng, kind)
        h = img.shape[0]
        if filters == "mixed":
            kind_sets = [np.arange(h) % 5, rng.integers(0, 3, h)]
        else:
            kind_sets = [np.full(h, ["none", "sub", "up", "average", "paeth"].index(filters))]
        for kinds in kind_sets:
            path = str(tmp_path / f"{kind}.png")
            driving_fixtures.write_filtered_png(path, img, kinds)
            got = images.read_png(path)
            np.testing.assert_array_equal(got, img, err_msg=f"{kind} {kinds}")
            np.testing.assert_array_equal(got, imageio.imread(path))


def test_png_writer_and_the_fallbacks(tmp_path, monkeypatch):
    """write_png's gray and RGB files read back through imageio; a palette
    PNG goes through imageio, and raises naming the file without it; a JPG
    is decoded by the port itself (read_jpeg), with or without imageio;
    image_shape reads a JPG's size from its header."""
    rng = np.random.default_rng(3)
    gray, rgb = _image(rng, "gray"), _image(rng, "rgb")
    for name, img in (("g.png", gray), ("g1.png", gray[..., None]), ("c.png", rgb)):
        images.write_png(str(tmp_path / name), img)
        np.testing.assert_array_equal(imageio.imread(str(tmp_path / name)),
                                      img.reshape(imageio.imread(str(tmp_path / name)).shape))
    with pytest.raises(ValueError):
        images.write_png(str(tmp_path / "bad.png"), rgb.astype(np.float32))
    jpg, pal = str(tmp_path / "x.jpg"), str(tmp_path / "p.png")
    imageio.imwrite(jpg, rgb)
    from PIL import Image

    Image.fromarray(rgb).convert("P").save(pal)
    for path in (jpg, pal):
        with pytest.raises(images.UnsupportedImage):
            images.read_png(path)
        np.testing.assert_array_equal(images.read_image(path), imageio.imread(path))
    assert images.image_shape(jpg) == rgb.shape[:2]
    jpg_pixels = imageio.imread(jpg)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="p.png"):
        images.read_image(pal)
    np.testing.assert_array_equal(images.read_image(jpg), jpg_pixels)
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "c.png")), rgb)


def test_index_files_are_the_jax_packages():
    jdir = os.path.join(os.path.dirname(jdriving.__file__), "index")
    tdir = os.path.join(os.path.dirname(driving.__file__), "index")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 4
    match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert match == names and not mismatch and not errors


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A nuScenes tree at 1/5 of its camera (both Mask-RCNN schemas give
    the same masks), a KITTI tree at 1/3 and a Waymo tree at 1/5."""
    root = tmp_path_factory.mktemp("driving")
    nusc = driving_fixtures.build_nusc_tree(str(root / "nusc"), 320, 180, lidar_points=6800)
    driving_fixtures.build_kitti_tree(str(root / "kitti"), width=414, height=125,
                                      lidar_points=20000)
    driving_fixtures.build_kitti_tree(str(root / "waymo"), is_waymo=True, width=384,
                                      height=256, lidar_points=20000)
    return {"root": root, "nusc": nusc}


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["img"], want["img"], rtol=0, atol=RESIZE_ATOL)
    for key in set(want) - {"img"}:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


def test_nusc_samples_match_the_jax_reader(trees):
    """Every annotation of the tree (near cars shrunk, far ones enlarged
    by the crop; LiDAR depth, the occluding person's mask), and the
    external poses a SUP-NeRF file gives."""
    root, info = str(trees["root"] / "nusc"), trees["nusc"]
    poses = {ann: {cam: torch.randn(2, 3, 4) for cam in ("CAM_FRONT",)}
             for ann, _ in info["annotations"]}
    pose_file = str(trees["root"] / "codes+poses.pth")
    torch.save({"optimized_poses": poses}, pose_file)
    kw = dict(img_size=32, white_bkgd=True, index_file=info["index_file"],
              external_pose_file=pose_file)
    got = nusc_lite.NuScenesDrivingDataset(root, info["version"], **kw)
    want = jnusc.NuScenesDrivingDataset(root, info["version"], **kw)
    assert len(got) == len(want) == 4
    for i in range(len(want)):
        g, w = got[i], want[i]
        _assert_samples_equal(g, w)
        assert (g["depth"] > 0).any() and (g["mask"] > 0).any() and "obj_pose_ext" in g
    # The LiDAR projection without the image's size in the table: the
    # header gives it, the JAX reader decodes the image.
    lite, jlite = got.nusc, want.nusc
    for args in (("sd_lid0", "sd_cam0"), ("sd_lid1", "sd_cam1")):
        for a, b in zip(lite.map_pointcloud_to_image(*args), jlite.map_pointcloud_to_image(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["kitti", "waymo"])
def test_kitti_samples_match_the_jax_reader(trees, layout):
    """The first two valid samples of the package's index (its default)."""
    kw = dict(img_size=32, white_bkgd=True)
    if layout == "waymo":
        kw.update(split="validation", is_waymo=True)
    root = str(trees["root"] / layout)
    got, want = driving.KittiDrivingDataset(root, **kw), jdriving.KittiDrivingDataset(root, **kw)
    assert len(got) == len(want) > 2
    for i in range(2):
        g, w = got[i], want[i]
        _assert_samples_equal(g, w)
        assert (g["depth"] > 0).sum() > 10 and g["mask"].sum() > 0


def test_crop_for_inversion_matches_the_jax_package():
    """A shrunk and an enlarged crop, white and grey backgrounds, a box
    over the image's edge (padding)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    mask_occ = rng.integers(-1, 2, (60, 80)).astype(np.int32)
    depth = np.where(rng.random((60, 80)) < 0.1, rng.uniform(2, 9, (60, 80)), 0).astype(np.float32)
    K = np.array([[50.0, 0, 40], [0, 50.0, 30], [0, 0, 1]])
    for box, size, white in (([10, 5, 70, 52], 32, True), ([30, 20, 41, 27], 32, False),
                             ([-6, 40, 30, 75], 16, True)):
        got = driving.crop_for_inversion(img, mask_occ, depth, box, K, size, white)
        want = jdriving.crop_for_inversion(img, mask_occ, depth, box, K, size, white)
        _assert_samples_equal(got, want)


def test_reproject_depth_matches_the_jax_package():
    """Random sparse depth, intrinsics and rigid perturbations: equal,
    including which point wins a contended pixel."""
    rng = np.random.default_rng(5)
    from scipy.spatial.transform import Rotation

    for S in (16, 64):
        depth = np.where(rng.random((S, S)) < 0.3, rng.uniform(2, 9, (S, S)), 0).astype(np.float32)
        K = np.array([[rng.uniform(1, 5), 0, rng.uniform(-0.1, 0.1)],
                      [0, 0, rng.uniform(-0.1, 0.1)], [0, 0, 1]])
        K[1, 1] = K[0, 0]
        for _ in range(3):
            M = np.eye(4)
            M[:3, :3] = Rotation.from_rotvec(rng.uniform(-0.1, 0.1, 3)).as_matrix()
            M[:3, 3] = rng.normal(0, 0.2, 3)
            got = eval_driving.reproject_depth(depth, K, M)
            np.testing.assert_array_equal(got, jax_eval_driving.reproject_depth(depth, K, M))
            assert (got > 0).any()
    assert not eval_driving.reproject_depth(np.zeros((8, 8), np.float32), K, M).any()


def test_devkit_matches_the_jax_package(tmp_path, monkeypatch):
    """tests/test_driving.py::TestDevkit's calibration, labels and scans
    through both packages' devkits: projections, 3D boxes, the BEV raster,
    the rigid and depth helpers, and the drawings (the JAX package's numpy
    line rasterizer, cv2 hidden from it)."""
    calib_path = tmp_path / "000000.txt"
    calib_path.write_text(test_driving.TestDevkit.CALIB)
    calib = driving.KittiCalibration(str(calib_path))
    jcalib = jdriving.KittiCalibration(str(calib_path))
    rng = np.random.default_rng(0)
    velo = rng.uniform([2, -10, -2], [60, 10, 1], (200, 3))
    uvd = rng.uniform([0, 0, 2], [1200, 370, 60], (64, 3))
    for name, x in (("project_velo_to_rect", velo), ("project_velo_to_image", velo),
                    ("project_velo_to_4p", velo), ("project_image_to_velo", uvd),
                    ("project_rect_to_velo", velo)):
        np.testing.assert_array_equal(getattr(calib, name)(x), getattr(jcalib, name)(x), name)
    depth = rng.uniform(2, 60, (8, 12))
    np.testing.assert_array_equal(calib.project_depth_to_velo(depth),
                                  jcalib.project_depth_to_velo(depth))
    for a, b in zip(driving.lidar_in_image_fov(velo, calib, 1242, 375),
                    jdriving.lidar_in_image_fov(velo, jcalib, 1242, 375)):
        np.testing.assert_array_equal(a, b)

    lines = ("Car 0.1 1 -1.57 100 150 300 250 1.5 1.6 3.9 1.0 1.5 20.0 -1.2",
             "Car 0.0 0 0.0 0 0 10 10 1.5 1.6 3.9 0.0 1.0 -5.0 0.0")
    for line in lines:
        obj, jobj = driving.KittiLabel.parse(line), jdriving.KittiLabel.parse(line)
        for fn in ("compute_box_3d", "compute_orientation_3d"):
            for a, b in zip(getattr(devkit, fn)(obj, calib.P), getattr(jdevkit, fn)(jobj, jcalib.P)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    lidar = np.concatenate([rng.uniform([0.5, -29, -3.4], [99, 29, 0.55], (3000, 3)),
                            rng.uniform(0, 1, (3000, 1))], axis=1).astype(np.float32)
    top = devkit.lidar_to_top(lidar)
    np.testing.assert_array_equal(top, jdevkit.lidar_to_top(lidar))
    for x, y in [(0.7, -3.2), (50.0, 10.0), (99.0, 29.0)]:
        assert devkit.lidar_to_top_coords(x, y) == jdevkit.lidar_to_top_coords(x, y)
    R = devkit.rotz(0.3) @ devkit.roty(-0.2) @ devkit.rotx(1.1)
    np.testing.assert_array_equal(R, jdevkit.rotz(0.3) @ jdevkit.roty(-0.2) @ jdevkit.rotx(1.1))
    Tr = devkit.transform_from_rot_trans(R, np.array([1.0, -2.0, 3.0]))[:3]
    np.testing.assert_array_equal(devkit.inverse_rigid_trans(Tr), jdevkit.inverse_rigid_trans(Tr))
    dmap = np.arange(12, dtype=np.float64).reshape(3, 4)
    np.testing.assert_array_equal(devkit.get_depth_pt3d(dmap), jdevkit.get_depth_pt3d(dmap))
    obj = driving.KittiLabel.parse(lines[0])
    big = rng.uniform(1, 50, (370, 1224))
    np.testing.assert_array_equal(devkit.depth_region_pt3d(big, obj),
                                  jdevkit.depth_region_pt3d(big, jdriving.KittiLabel.parse(lines[0])))
    corners_velo = calib.project_rect_to_velo(devkit.compute_box_3d(obj, calib.P)[1])
    np.testing.assert_array_equal(devkit.velo_points_in_box3d(lidar[:, :3], corners_velo),
                                  jdevkit.velo_points_in_box3d(lidar[:, :3], corners_velo))

    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX devkit's numpy lines
    img = np.zeros((370, 1224, 3), np.uint8)
    jobj = jdriving.KittiLabel.parse(lines[0])
    for show3d in (True, False):
        got = devkit.show_image_with_boxes(img, [obj], calib, show3d=show3d)
        np.testing.assert_array_equal(got, jdevkit.show_image_with_boxes(img, [jobj], jcalib,
                                                                         show3d=show3d))
        assert got.sum() > 0
    top_img = devkit.draw_top_image(top)
    np.testing.assert_array_equal(top_img, jdevkit.draw_top_image(top))
    np.testing.assert_array_equal(devkit.draw_box3d_on_top(top_img, [corners_velo]),
                                  jdevkit.draw_box3d_on_top(top_img, [corners_velo]))

    # A KITTI depth PNG (16-bit, value / 256 metres) against PIL's reader.
    png = str(tmp_path / "depth.png")
    imageio.imwrite(png, rng.integers(0, 65535, (30, 40)).astype(np.uint16))
    np.testing.assert_array_equal(devkit.load_depth_png(png), jdevkit.load_depth_png(png))
