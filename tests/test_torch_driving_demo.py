"""The port's driving demo (demo_driving.py in nerf_from_image_tpu_torch)
against the JAX package's on the first frame of a nuScenes tree
(data/driving_fixtures.py, Mask-RCNN instances in the reference's 'labels'
schema; the JAX demo's own test covers COCO 'classes'): the frame lookup
through sample_data's channel, both cars cropped (the person is not a car),
2 refinement steps each from the average w, and the rows of input | coords
| recon | depth | normals | novel view. One JAX run and one port run,
patched as tests/test_torch_driving.py does, at 16^2 without the encoder
(the evaluation's tests cover it and PnP); panels within 1e-4, the normals
panel 1e-3.
"""

import os

import numpy as np
import pytest

from nerf_from_image_tpu_torch import demo_driving
from tests.test_torch_driving import (  # noqa: F401  (files: a fixture)
    COMMON,
    _assert_composites_agree,
    _jax_run,
    _port_env,
    files,
)
from tests.test_torch_generator import release_memory  # noqa: F401

RES = 16


def test_demo_matches_jax(files, tmp_path):  # noqa: F811
    frame = files["nusc"]["frames"][0]
    argv = (["--dataset", "nusc", "--nusc_data_dir", str(files["root"] / "nusc"),
             "--inv_manual_input_path", frame, "--resume_from", files["generator"]]
            + COMMON + ["--resolution", str(RES)])
    jrows, rows = [], []
    _jax_run(files, tmp_path / "jax", "demo_driving", argv, jrows)
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, files, tmp_path, rows)
        stats = demo_driving.main(argv + ["--device", "cpu"])
    assert stats["cars"] == 2 and len(stats["parts_ms"]["refine"]) == 2
    (path, panels), = rows
    assert path == os.path.join("outputs", f"demo_nusc_{frame[:-4]}.png")
    assert len(panels) == 2 and all(len(r) == 6 for r in panels)
    assert all(p.shape == (RES, RES, 3) for r in panels for p in r)
    _assert_composites_agree(rows, jrows, normals_panel=4)
    assert (tmp_path / path).exists()


def test_demo_reads_coco_class_ids(files, tmp_path):  # noqa: F811
    """The same frame with the Mask-RCNN dump in COCO 'classes' ids: the
    same two cars, cropped to the same inputs, on the port."""
    from nerf_from_image_tpu_torch.data import driving_fixtures

    nusc = driving_fixtures.build_nusc_tree(str(tmp_path / "nusc"), 320, 180, lidar_points=6800,
                                            label_schema="classes")
    argv = (["--dataset", "nusc", "--nusc_data_dir", str(tmp_path / "nusc"),
             "--inv_manual_input_path", nusc["frames"][0], "--resume_from", files["generator"]]
            + COMMON + ["--resolution", str(RES), "--inv_steps", "1", "--device", "cpu"])
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, files, tmp_path, rows)
        assert demo_driving.main(argv)["cars"] == 2
    (_, panels), = rows
    # Instances 0 and 2 of the labels tree's dump (1 is the person): the
    # trees are the same scene from the same seed.
    from nerf_from_image_tpu_torch.data import driving
    from nerf_from_image_tpu_torch.data.nusc_lite import NuScenesLite
    from nerf_from_image_tpu_torch.utils.images import read_image

    root = files["root"] / "nusc"
    path, _, K = NuScenesLite("v1.0-mini", str(root)).get_sample_data("sd_cam0")
    preds, masks = driving.load_instance_masks(str(root / "pred_instance" / "CAM_FRONT"),
                                               nusc["frames"][0][:-4])
    assert preds["labels"] == ["car", "person", "car"]
    img = read_image(path)[..., :3]
    for row, i in zip(panels, (0, 2)):
        want = driving.crop_for_inversion(img, driving.get_mask_occ_from_ins(masks, i), None,
                                          preds["boxes"][i], K, RES, False)["img"]
        np.testing.assert_array_equal(row[0], want)
