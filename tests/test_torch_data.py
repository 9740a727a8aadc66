"""The port's data layer and command line against the JAX package's.

Both packages get the same inputs: dataset names, argv lists, seeded
arrays, and tiny dataset fixtures written here (p3d and ImageNet
collections with RLE masks, CUB .mat annotations, SRN object folders,
CARLA renders, demo images with an alpha channel or a sibling mask). The
port's arrays must equal the JAX package's, bit for bit and dtype for
dtype, but for resized images: the port resizes in numpy, cv2's arithmetic
summed in another order (tests/test_torch_driving_data.py holds the
resizes to cv2), so these agree within RESIZE_ATOL, dtype for dtype.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nerf_from_image_tpu import arguments as jargs
from nerf_from_image_tpu.data import coco_mask as jrle
from nerf_from_image_tpu.data import configs as jconfigs
from nerf_from_image_tpu.data import image_ops as jops
from nerf_from_image_tpu.data import loaders as jloaders
from nerf_from_image_tpu.data import splits as jsplits
from nerf_from_image_tpu.data import synthetic as jsynth
from nerf_from_image_tpu_torch import arguments as targs
from nerf_from_image_tpu_torch.data import coco_mask as trle
from nerf_from_image_tpu_torch.data import configs as tconfigs
from nerf_from_image_tpu_torch.data import image_ops as tops
from nerf_from_image_tpu_torch.data import loaders as tloaders
from nerf_from_image_tpu_torch.data import splits as tsplits
from nerf_from_image_tpu_torch.data import synthetic as tsynth
from tests.test_torch_generator import release_memory  # noqa: F401


RESIZE_ATOL = 1e-6  # on [0, 1] or [-1, 1] images


def _close(a, b):
    """Resized images: the same dtype and shape, values within RESIZE_ATOL."""
    assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (a, b)
    np.testing.assert_allclose(a, b, rtol=0, atol=RESIZE_ATOL)


def _same(a, b):
    """Equal values, and for arrays equal bits, shapes and dtypes."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (a, b)
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


def _same_split(a, b, resized=()):
    """Equal splits; the fields named in `resized` hold resized images."""
    if b is None:
        assert a is None
        return
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if y is None:
            assert x is None, f.name
        elif f.name in resized:
            _close(np.asarray(x), np.asarray(y))
        else:
            _same(x, y)


# ---- configs, overrides, command line ---------------------------------

NAMES = sorted(jconfigs.DATASET_CONFIGS) + ["shapenet_planes", "p3d_bus", "imagenet_dog"]


@pytest.mark.parametrize("name", NAMES)
def test_dataset_configs_and_overrides_match_jax(name):
    assert dataclasses.asdict(tconfigs.get_dataset_config(name)) == \
        dataclasses.asdict(jconfigs.get_dataset_config(name))
    assert dataclasses.asdict(tloaders.get_train_overrides(name)) == \
        dataclasses.asdict(jloaders.get_train_overrides(name))


def test_unknown_names_raise_and_lookups_match_jax():
    with pytest.raises(ValueError):
        tconfigs.get_dataset_config("nope")
    assert tloaders.get_coco_mapping() == jloaders.get_coco_mapping()
    for name in ("g_p3d_car_res128.pth", "r_x_carla_nofine", "g_shapenet_chairs_res64"):
        assert tloaders.autodetect_dataset(name) == jloaders.autodetect_dataset(name)
    with pytest.raises(RuntimeError):
        tloaders.autodetect_dataset("no_dataset_here")


ARGVS = [
    [],
    ["--dataset", "carla", "--xid", "x1", "--use_viewdir", "--inv_export_demo_sample",
     "--attention_values", "0", "--path_length_regularization"],
    ["--gpus", "2", "--dual_discriminator_l1", "--fine_sampling", "false", "--use_sdf", "no",
     "--augment_p", "0.5", "--augment_ada", "--perturb_poses", "0.1", "--use_class"],
    ["--inv_manual_input_path", "a.png", "--plane_splat", "1", "--dual_discriminator_mse",
     "--conditional_pose", "F", "--r1", "0", "--use_encoder", "--supervise_alpha"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "carla", "gpus", "manual"])
def test_parse_args_and_experiment_name_match_jax(argv):
    port, ref = vars(targs.parse_args(argv)), vars(jargs.parse_args(argv))
    assert port.pop("device") == "cuda"
    assert port == ref
    assert targs.suggest_experiment_name(targs.parse_args(argv)) == \
        jargs.suggest_experiment_name(jargs.parse_args(argv))
    assert targs.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_bool_flag_rejects_garbage():
    for v in ("true", "No", "1", "", True):
        assert targs.bool_flag(v) == jargs.bool_flag(v)
    with pytest.raises(SystemExit):
        targs.parse_args(["--fine_sampling", "maybe"])


# ---- splits, samplers, image ops ----------------------------------------


def test_splits_and_samplers_match_jax():
    rng = np.random.default_rng(0)
    arrays = dict(images=rng.random((9, 2, 2, 3)).astype(np.float32),
                  tform_cam2world=rng.random((9, 4, 4)).astype(np.float32),
                  focal_length=rng.random(9).astype(np.float32),
                  bbox=rng.random((9, 2, 2)).astype(np.float32))
    idx = np.array([4, 0, 4, 7])
    _same_split(tsplits.DatasetSplit(**arrays).select(idx),
                jsplits.DatasetSplit(**arrays).select(idx))
    for n, imagenet in ((9000, False), (50, True), (12, False)):
        split = (tsplits.DatasetSplit(images=np.zeros((n, 1, 1, 1), np.float32)),
                 jsplits.DatasetSplit(images=np.zeros((n, 1, 1, 1), np.float32)))
        _same(tsplits.compute_eval_indices(split[0], is_imagenet=imagenet),
              jsplits.compute_eval_indices(split[1], is_imagenet=imagenet))
    for views in (1, 3, 50):
        indices = np.arange(0, 30, 2)
        _same(tsplits.compute_view_perm(indices, views), jsplits.compute_view_perm(indices, views))
    _same(tsplits.draw_eval_latents(5, 7), jsplits.draw_eval_latents(5, 7))
    port, ref = (tsplits.EndlessSampler(7, np.random.RandomState(3)),
                 jsplits.EndlessSampler(7, np.random.RandomState(3)))
    for _ in range(5):
        _same(port(3), ref(3))
    port, ref = tsplits.StepIndexedSampler(13, seed=5), jsplits.StepIndexedSampler(13, seed=5)
    for step in (0, 4, 11, 2):
        _same(port(step, 6), ref(step, 6))


def test_image_ops_match_jax():
    rng = np.random.default_rng(1)
    img = rng.random((13, 17, 3))
    mask = rng.random((13, 17, 1))
    for scale in (0.5, 1.7, 8 / 17):
        for x in (img, mask):
            (got, got_f), (want, want_f) = tops.resize_area(x, scale), jops.resize_area(x, scale)
            _close(got, want)
            _same(got_f, want_f)
    for area in (True, False):
        _close(tops.resize_to(img, (6, 9), area), jops.resize_to(img, (6, 9), area))
    _same(tops.avg_pool2(img), jops.avg_pool2(img))
    bbox = [2.0, 3.0, 11.5, 9.0]
    _same(tops.perturb_bbox(bbox, 0.05, 0.1, np.random.default_rng(2)),
          jops.perturb_bbox(bbox, 0.05, 0.1, np.random.default_rng(2)))
    sq = tops.square_bbox(bbox)
    _same(sq, jops.square_bbox(bbox))
    for bg, x in ((1.0, img), (0.0, mask), (0.5, img[..., 0])):
        _same(tops.crop_padded(x, [-3, 4, 20, 27], bg), jops.crop_padded(x, [-3, 4, 20, 27], bg))
    _same(tops.normalized_bbox(sq, 13, 17), jops.normalized_bbox(sq, 13, 17))
    _same(tops.normalized_bbox([1, 0, 9, 8], 17, 13), jops.normalized_bbox([1, 0, 9, 8], 17, 13))
    _same(tops.mirror_bbox(bbox, 17), jops.mirror_bbox(bbox, 17))


# ---- RLE codec ----------------------------------------------------------


def _masks():
    rng = np.random.default_rng(3)
    return [(rng.random((h, w)) > t).astype(np.uint8)
            for h, w, t in ((1, 1, 0.5), (7, 3, 0.1), (64, 64, 0.9), (33, 1, 0.5))] + [
        np.zeros((5, 9), np.uint8), np.ones((5, 9), np.uint8)]


def test_rle_encode_decode_match_jax():
    for mask in _masks():
        port, ref = trle.encode(mask), jrle.encode(mask)
        assert port == ref
        _same(trle.decode(ref), jrle.decode(ref))
        _same(trle.decode({"size": ref["size"], "counts": ref["counts"].decode("ascii")}),
              mask)
    uncompressed = {"size": [2, 3], "counts": [1, 2, 3]}
    _same(trle.decode(uncompressed), jrle.decode(uncompressed))


@pytest.mark.parametrize("rle", [
    {"size": [1, 1], "counts": bytes([48 + 0x20])},  # truncated: continuation on the last byte
    {"size": [4, 4], "counts": [1, 2]},  # runs short of the mask
    {"size": [10, 10], "counts": [-5, 105]},  # a negative run, total right
], ids=["truncated", "short", "negative"])
def test_rle_rejects_malformed_input_like_jax(rle):
    with pytest.raises(ValueError):
        trle.decode(rle)
    with pytest.raises((ValueError, AssertionError, IndexError)):
        jrle.decode(rle)


# ---- synthetic ----------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(seed=1, white_background=False),
                                dict(seed=7, with_mask_channel=True)],
                         ids=["default", "black", "mask"])
def test_synthetic_split_is_bit_equal(kw):
    _same_split(tsynth.make_synthetic_split(12, 16, **kw),
                jsynth.make_synthetic_split(12, 16, **kw))


# ---- dataset fixtures ---------------------------------------------------


def _write_png(path, arr):
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, arr)


def _write_collection(root, rel_dir, names, pose_file, seed):
    """A p3d/ImageNet collection: images, detections with RLE masks and
    the estimated poses as .npz (as tests/test_data_layer.py writes
    them, with masks)."""
    rng = np.random.RandomState(seed)
    dets = []
    for name in names:
        h, w = rng.randint(9, 15, 2)
        _write_png(os.path.join(root, rel_dir, "images", name),
                   rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        mask = np.zeros((h, w), np.uint8)
        mask[2:h - 2, 1:w - 3] = 1
        x0, y0 = rng.randint(0, 3, 2)
        dets.append({"image_path": os.path.join("datasets", rel_dir, "images", name),
                     "bbox": np.array([x0, y0, w - 2, h - 1], float),
                     "mask": jrle.encode(mask)})
    np.save(os.path.join(root, rel_dir, "detections.npy"), np.array(dets, dtype=object))
    n = len(names)
    np.savez(os.path.join(root, rel_dir, pose_file + ".npz"),
             indices=np.arange(n)[::-1].copy(),
             z0=rng.normal(0, 0.3, (n, 1)).astype(np.float32),
             s=rng.uniform(0.8, 1.2, (n, 1)).astype(np.float32),
             t=rng.normal(0, 0.1, (n, 2)).astype(np.float32),
             R=rng.normal(0, 1, (n, 4)).astype(np.float32))


def _p3d_fixture(root):
    _write_collection(root, "p3d/p3d_car", ["a.png", "b.png", "c.png"],
                      "poses_estimated_singletpl_perspective.bin", 0)
    _write_collection(root, "imagenet/imagenet_car", ["b.png", "d.png", "e.png"],
                      "poses_estimated_multitpl_perspective.bin", 1)
    return dict(dataset="p3d_car", resolution=8, need_test=True, imagenet_testset=True)


def _cub_fixture(root):
    import scipy.io

    rng = np.random.RandomState(2)
    data_dir = os.path.join(root, "cub", "CUB_200_2011")
    names = ["001.Bird/a.jpg", "002.Other/b.jpg"]
    with open(os.path.join(_mkdir(data_dir), "images.txt"), "w") as f:
        f.writelines(f"{i + 1} {n}\n" for i, n in enumerate(names))
    with open(os.path.join(data_dir, "image_class_labels.txt"), "w") as f:
        f.writelines(f"{i + 1} {i + 1}\n" for i in range(len(names)))
    for split in ("train", "test"):
        images, sfm = [], []
        for n in names:
            h, w = rng.randint(10, 16, 2)
            _write_png(os.path.join(data_dir, "images", n[:-4] + ".png"),
                       rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
            os.replace(os.path.join(data_dir, "images", n[:-4] + ".png"),
                       os.path.join(data_dir, "images", n))
            mask = np.zeros((h, w), np.uint8)
            mask[3:h - 2, 2:w - 2] = 1
            images.append({"rel_path": n, "mask": mask,
                           "bbox": {"x1": 2.0, "y1": 3.0, "x2": w - 1.0, "y2": h - 2.0}})
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            sfm.append({"rot": q * np.sign(np.linalg.det(q)), "scale": rng.uniform(2, 4),
                        "trans": rng.uniform(4, 8, 2)})
        scipy.io.savemat(os.path.join(_mkdir(os.path.join(root, "cub", "data")),
                                      f"{split}_cub_cleaned.mat"),
                         {"images": np.array(images, dtype=object)})
        scipy.io.savemat(os.path.join(_mkdir(os.path.join(root, "cub", "sfm")),
                                      f"anno_{split}.mat"),
                         {"sfm_anno": np.array(sfm, dtype=object)})
    return dict(dataset="cub", resolution=8, augment_p=0.0, need_test=True, use_class=True)


def _srn_fixture(root):
    rng = np.random.default_rng(3)
    for stage, n_obj in (("train", 2), ("test", 1)):
        for obj in range(n_obj):
            d = os.path.join(root, "shapenet", f"cars_{stage}", f"obj{obj}")
            with open(os.path.join(_mkdir(d), "intrinsics.txt"), "w") as f:
                f.write(f"20.0 {7 + obj} 9.0 0.0\n")
            for v in range(3):
                _write_png(os.path.join(d, "rgb", f"{v:06d}.png"),
                           (rng.random((16, 16, 3)) * 255).astype(np.uint8))
                pose = np.eye(4, dtype=np.float32)
                pose[:3, 3] = rng.normal(size=3)
                np.savetxt(os.path.join(_mkdir(os.path.join(d, "pose")), f"{v:06d}.txt"),
                           pose.reshape(-1))
    return dict(dataset="shapenet_cars", resolution=8, need_test=True)


def _carla_fixture(root):
    rng = np.random.default_rng(4)
    poses_dir = _mkdir(os.path.join(root, "carla", "carla_poses"))
    for i in range(3):
        _write_png(os.path.join(root, "carla", f"{i:04d}.png"),
                   (rng.random((24, 24, 4)) * 255).astype(np.uint8))
        np.save(os.path.join(poses_dir, f"{i:04d}_extrinsics.npy"),
                rng.normal(size=(3, 4)).astype(np.float32))
    intr = np.zeros((1, 1, 3, 3), np.float32)
    intr[0, 0] = [[30.0, 0, 12.0], [0, 30.0, 12.0], [0, 0, 1]]
    np.save(os.path.join(poses_dir, "intrinsics.npy"), intr)
    # augment_p=None takes CARLA's ADA preset: the 2x images and their pool.
    return dict(dataset="carla", resolution=8, augment_p=None)


def _mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


FIXTURES = {"p3d": _p3d_fixture, "cub": _cub_fixture, "srn": _srn_fixture,
            "carla": _carla_fixture}


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_load_dataset_matches_jax(kind, tmp_path):
    kw = FIXTURES[kind](str(tmp_path))
    dataset = kw.pop("dataset")
    port = tloaders.load_dataset(dataset, str(tmp_path), **kw)
    ref = jloaders.load_dataset(dataset, str(tmp_path), **kw)
    assert dataclasses.asdict(port[0]) == dataclasses.asdict(ref[0])
    assert len(port[1]) > 0
    for a, b in zip(port[1:], ref[1:]):
        _same_split(a, b, resized=("images", "images_highres"))


@pytest.mark.parametrize("source", ["alpha", "sibling_mask", "none"])
def test_load_manual_image_matches_jax(source, tmp_path):
    rng = np.random.RandomState(5)
    path = str(tmp_path / "car.png")
    if source == "alpha":
        img = (rng.rand(30, 44, 4) * 255).astype(np.uint8)
        img[..., 3] = 0
        img[8:22, 12:38, 3] = 255
    else:
        img = (rng.rand(32, 28, 3) * 255).astype(np.uint8)
    _write_png(path, img)
    if source == "sibling_mask":
        m = np.zeros((32, 28), np.uint8)
        m[6:25, 4:20] = 255
        _write_png(str(tmp_path / "car_mask.png"), m)
    if source == "none":
        # Without a mask the JAX package needs detectron2; both refuse.
        with pytest.raises(RuntimeError, match="No mask"):
            tloaders.load_manual_image(path, 16, 2)
        with pytest.raises(RuntimeError):
            jloaders.load_manual_image(path, 16, 2)
        return
    port, ref = tloaders.load_manual_image(path, 16), jloaders.load_manual_image(path, 16)
    assert port.keys() == ref.keys()
    for k in ref:
        _same(port[k], ref[k])
    assert port["img"].shape == (16, 16, 4)


def test_cub_pose_quaternion_uses_the_port_pose_helper():
    """CUB's SfM rotation goes through pose.matrix_to_quaternion in both
    packages: the port's torch version gives JAX's quaternions."""
    from nerf_from_image_tpu.pose.pose import matrix_to_quaternion as jq
    from nerf_from_image_tpu_torch.pose.pose import matrix_to_quaternion as tq

    rng = np.random.default_rng(6)
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.pad(q * np.sign(np.linalg.det(q)), (0, 1))
        m[3, 3] = 1
        np.testing.assert_allclose(tq(torch.as_tensor(m[None], dtype=torch.float32)).numpy(),
                                   np.asarray(jq(m[None].astype(np.float32))), atol=1e-6)
