"""The port stands alone: no JAX, nothing of the JAX package, and entry
points that run on the card unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import nerf_from_image_tpu_torch
from tests.test_torch_generator import release_memory  # noqa: F401

PKG_DIR = os.path.dirname(nerf_from_image_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_BLOCKER = r"""
import importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_from_image_tpu", "scripts",
           "timing")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import nerf_from_image_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
"""


# What the card machine lacks besides JAX: image I/O, TensorBoard, OpenCV
# and detectron2. With those blocked too, the driver still imports, builds
# the synthetic split, logs to a no-op TensorBoard sink, writes its demo
# PNG (the standard library's zlib) and decodes the committed JPEG frame.
_CARD_MACHINE = _BLOCKER.replace(
    '"timing")', '"timing", "imageio", "PIL", "tensorboardX", "cv2", "detectron2")'
).split("import nerf_from_image_tpu_torch as pkg")[0] + r"""
import os, sys, tempfile
import numpy as np
import nerf_from_image_tpu_torch.invert
from nerf_from_image_tpu_torch.data.loaders import load_dataset
from nerf_from_image_tpu_torch.utils import images, tb

config, train, _, _ = load_dataset("synthetic", "unused", resolution=16, max_images=3)
assert train.images.shape == (3, 16, 16, 3), train.images.shape
logger = tb.Logger(tempfile.mkdtemp())
logger.images("img", train.images, 0)
path = os.path.join(tempfile.mkdtemp(), "outputs", "grid.png")
images.save_image_grid([[im, -im] for im in train.images], path)
grid = images.read_png(path)
assert grid.shape == (48, 32, 3), grid.shape
from nerf_from_image_tpu_torch.data.jpeg import FIXTURE_DIR
frame = images.read_image(os.path.join(FIXTURE_DIR, "n008-fixture__CAM_FRONT__0000.jpg"))
assert frame.shape == (900, 1600, 3), frame.shape
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("ok")
"""


# The driving data path on the card machine: with JAX, imageio, PIL and
# cv2 blocked, the fixture trees are written, each dataset's samples read
# (PNG decode, LiDAR depth, the crop's area and nearest resizes) and a
# crop taken as the demo takes it.
_DRIVING_DATA = _BLOCKER.replace(
    '"timing")', '"timing", "imageio", "PIL", "cv2")'
).split("import nerf_from_image_tpu_torch as pkg")[0] + r"""
import os, sys, tempfile
import numpy as np
from nerf_from_image_tpu_torch.data import driving, driving_fixtures, nusc_lite

root = tempfile.mkdtemp()
info = driving_fixtures.build_nusc_tree(os.path.join(root, "nusc"), 320, 180,
                                        lidar_points=6800)
ds = nusc_lite.NuScenesDrivingDataset(os.path.join(root, "nusc"), info["version"],
                                      img_size=32, white_bkgd=True,
                                      index_file=info["index_file"])
for i in range(len(ds)):
    s = ds[i]
    assert s["img"].shape == (32, 32, 3) and (s["depth"] > 0).any(), i
for waymo in (False, True):
    sub = os.path.join(root, "waymo" if waymo else "kitti")
    driving_fixtures.build_kitti_tree(sub, is_waymo=waymo, width=414, height=125,
                                      lidar_points=20000)
    kd = driving.KittiDrivingDataset(sub, img_size=32, white_bkgd=True,
                                     split="validation" if waymo else "training",
                                     is_waymo=waymo)
    assert all((kd[i]["depth"] > 0).any() for i in range(2))
frame = os.path.join(root, "nusc", "samples", "CAM_FRONT", info["frames"][0])
preds, masks = driving.load_instance_masks(
    os.path.join(root, "nusc", "pred_instance", "CAM_FRONT"), info["frames"][0][:-4])
from nerf_from_image_tpu_torch.utils.images import read_image
crop = driving.crop_for_inversion(read_image(frame)[..., :3],
                                  driving.get_mask_occ_from_ins(masks, 0), None,
                                  preds["boxes"][0], np.eye(3), 64, white_bkgd=False)
assert crop["img"].shape == (64, 64, 3) and crop["mask"].shape == (64, 64)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("ok")
"""


def _modules():
    return [m.name for m in pkgutil.walk_packages(
        nerf_from_image_tpu_torch.__path__, "nerf_from_image_tpu_torch.")]


def test_every_module_imports_with_jax_blocked():
    names = _modules()
    for module in ("kernels.splat_probes", "profile_splat", "ops.grid_sample",
                   "engine.augment", "models.lpips", "metrics.image", "bench", "pose.pnp",
                   "models.segformer", "models.encoder", "engine.evaluate", "utils.fileio",
                   "invert", "arguments", "data.loaders", "data.coco_mask", "utils.images",
                   "utils.tb", "eval_driving", "demo_driving", "evaluate_saved_result",
                   "data.driving", "data.nusc_lite", "data.devkit", "data.driving_fixtures",
                   "engine.gan", "engine.regularizers", "models.discriminator",
                   "utils.checkpoint", "train", "metrics.fid", "models.inception",
                   "engine.gan_eval", "engine.coord_regressor", "train_encoder",
                   "parallel.mesh", "data.jpeg.make_fixtures"):
        assert f"nerf_from_image_tpu_torch.{module}" in names, module
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) == len(names) >= 38


def test_driver_imports_and_writes_its_png_without_the_card_machines_missing_packages():
    out = subprocess.run(
        [sys.executable, "-c", _CARD_MACHINE], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_driving_data_path_needs_no_cv2_imageio_or_pil():
    out = subprocess.run(
        [sys.executable, "-c", _DRIVING_DATA], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_no_source_names_the_jax_package():
    pattern = re.compile(r"\bnerf_from_image_tpu\.|^\s*(import|from)\s+(jax|flax|optax|scripts)\b",
                         re.MULTILINE)
    sources = [os.path.join(root, f) for root, _, files in os.walk(PKG_DIR)
               for f in files if f.endswith((".py", ".cu"))]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) >= 29
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        assert not pattern.search(text), path


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from nerf_from_image_tpu_torch.engine.inversion import InversionConfig, make_invert_fn
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.models.generator import Generator

    tiny = dict(latent_dim=8, scene_range=1.0, w_dim=8, synthesis_resolution=8,
                channel_base=64, channel_max=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(**tiny)
    model = Generator(**tiny, device="cpu")
    cam = torch.eye(4)[None]
    focal = torch.ones(1)
    ws = torch.zeros(1, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(RenderConfig(resolution=4, depth_samples_per_ray=4), model, cam, focal, ws)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_invert_fn(InversionConfig(loss="mse"), RenderConfig(), model)
    out, _ = render(RenderConfig(resolution=4, depth_samples_per_ray=4), model, cam,
                    focal, ws, device="cpu")
    assert out.rgb.shape == (1, 4, 4, 3)

    from nerf_from_image_tpu_torch.engine.evaluate import make_eval_fn
    from nerf_from_image_tpu_torch.invert import first_guess
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    from nerf_from_image_tpu_torch.models.segformer import Segformer

    small = dict(backbone_depths=(1, 1, 1, 1))
    for build in (lambda: BootstrapEncoder(8, **small),
                  lambda: Segformer(depths=(1, 1, 1, 1)),
                  lambda: make_eval_fn(InversionConfig(), RenderConfig(), model, None),
                  lambda: first_guess(None, torch.zeros(1, 4, 4, 3), ws, InversionConfig(),
                                      pose=cam, focal=focal)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    z0, p0 = first_guess(None, torch.zeros(1, 4, 4, 3), ws, InversionConfig(), pose=cam,
                         focal=focal, device="cpu")
    assert z0.shape == (1, 1, 8) and p0.q.shape == (1, 4)

    from nerf_from_image_tpu_torch import demo_driving, eval_driving

    for main in (eval_driving.main, demo_driving.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--dataset", "nusc", "--nusc_data_dir", "unused"])

    from nerf_from_image_tpu_torch import train
    from nerf_from_image_tpu_torch.models.discriminator import Discriminator

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Discriminator(8, 3, False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--dataset", "synthetic"])

    from nerf_from_image_tpu_torch import invert, train_encoder
    from nerf_from_image_tpu_torch.engine import coord_regressor, gan_eval
    from nerf_from_image_tpu_torch.models.inception import FIDInceptionV3

    for build in (lambda: train_encoder.main(["--dataset", "synthetic"]),
                  lambda: invert.main(["--dataset", "synthetic", "--inv_train_coord_only"]),
                  FIDInceptionV3,
                  lambda: gan_eval.make_recon_eval_fn(RenderConfig(), model),
                  lambda: gan_eval.compute_real_fid_stats(None, np.zeros((1, 4, 4, 3))),
                  lambda: coord_regressor.coord_train_step(
                      coord_regressor.CoordRegressorConfig(), RenderConfig(), model, None,
                      None, {"pose": cam})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
