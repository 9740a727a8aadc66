"""The port's driving evaluation against the JAX package's on a KITTI tree
(data/driving_fixtures.py): the ground-truth start with the average w's
layers collapsed to one w (`--inv_no_split`), the random-rotation
novel view with its NaN image columns and the LiDAR depth reprojected into
it, and the per-object composites. One JAX run and one port run, patched
and compared as tests/test_torch_driving.py does (same tolerances), at
16^2 without the encoder (the nuScenes file covers it and PnP). Then the
port on the nuScenes tree: the external-pose and empty-mask branches, and
the default known-K PnP start, whose poses are held to the JAX package's
PnP on the JAX reader's intrinsics (the nuScenes pair runs the focal
search).
"""

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch import eval_driving
from tests.test_torch_driving import (  # noqa: F401  (files: a fixture)
    RES,
    STEPS,
    SYN_COORDS,
    SYN_MASK,
    _PortSynthEncoder,
    _argv,
    _assert_composites_agree,
    _assert_reports_agree,
    _jax_run,
    _port_env,
    _report,
    files,
)
from tests.test_torch_generator import built_once, release_memory  # noqa: F401
from tests.test_torch_pnp import POSE_TOL

KITTI_RES = 16


@pytest.fixture(scope="module")
def kitti_runs(files, tmp_path_factory):  # noqa: F811
    """One JAX and one port eval_driving run on the KITTI tree's two cars,
    from the ground-truth pose and the mean of the average w's layers (they
    differ: a per-layer mean is not any one layer), with composites; once
    a session."""
    return built_once(tmp_path_factory, "kitti_runs", lambda root: _kitti_runs(files, root))


def _kitti_runs(files, root):  # noqa: F811
    argv = _argv(files, "kitti", encoder=False) + [
        "--resolution", str(KITTI_RES), "--init_pose_type", "gt", "--inv_no_split",
        "--inv_export_demo_sample"]
    jrows, rows = [], []
    _jax_run(files, root / "jax", "eval_driving", argv + ["--root_path", str(root / "jax")],
             jrows)
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, files, root, rows)
        stats = eval_driving.main(argv + ["--root_path", str(root / "port"), "--device", "cpu"])
    return {"jax": _report(root / "jax" / "reports" / "eval_kitti" / "report.npz"),
            "port": _report(root / "port" / "reports" / "eval_kitti" / "report.npz"),
            "jax_rows": jrows, "rows": rows, "stats": stats}


def test_kitti_report_matches_jax(kitti_runs):
    """Both cars at steps 0 and 2: the ground-truth start (rotation error
    ~0), the random-rotation view's depth error finite, its image columns
    NaN in both, with the report's note saying so."""
    want, got = kitti_runs["jax"], kitti_runs["port"]
    for step in (0, STEPS):
        for name in ("psnr_random", "ssim_random", "lpips_random"):
            assert np.isnan(want[f"step{step}/{name}"]).all()
            assert np.isnan(got[f"step{step}/{name}"]).all()
        assert np.isfinite(want[f"step{step}/depth_error_random"]).all()
        assert (want[f"step{step}/depth_error_random"] > 0).all()
    assert (want["step0/rot_error"] < 0.05).all() and want["step2/psnr"].shape == (2,)
    assert not np.allclose(want["step2/rot_error"], want["step0/rot_error"])
    _assert_reports_agree(got, want)
    assert "NaN by design" in str(got["__metric_notes__"])
    assert kitti_runs["stats"]["objects"] == 2


def test_kitti_composites_match_jax(kitti_runs):
    """input | recon | depth | random-view recon | random-view depth (no
    encoder: no coordinates panel)."""
    rows = kitti_runs["rows"]
    assert len(rows) == 2 and all(r[1][0][0].shape == (KITTI_RES, 5 * KITTI_RES, 3)
                                  for r in rows)
    _assert_composites_agree(rows, kitti_runs["jax_rows"])


def test_external_pose_start_and_empty_mask_skip(files, tmp_path):  # noqa: F811
    """--init_pose_type external starts from the file's refined world2cam
    (here each annotation's true object pose: rotation and translation
    errors ~0 at step 0, where PnP's are not); the default 'pnp' start
    solves known-K PnP on the encoder's map, rescaled to the driving scene,
    with each crop's intrinsics: its poses within the PnP test's 1e-4 of
    the JAX package's PnP on the JAX reader's K; an encoder mask that never
    passes 0.9 skips every object under 'pnp'."""
    import jax
    import jax.numpy as jnp

    import eval_driving as jax_eval
    import nerf_from_image_tpu.pose.pnp as jpnp
    from nerf_from_image_tpu.data import nusc_lite as jnusc
    from nerf_from_image_tpu.data.configs import get_dataset_config
    from nerf_from_image_tpu_torch.data.nusc_lite import NuScenesDrivingDataset
    from nerf_from_image_tpu_torch.pose import pnp as tpnp

    info = files["nusc"]
    ds = NuScenesDrivingDataset(str(files["root"] / "nusc"), info["version"], img_size=RES,
                                index_file=info["index_file"])
    poses = {}
    for i in range(len(ds)):
        s = ds[i]
        poses[s["anntoken"]] = {s["cam"]: torch.from_numpy(np.stack([s["obj_pose"]] * 2))}
    pose_file = str(tmp_path / "codes+poses.pth")
    torch.save({"optimized_poses": poses}, pose_file)
    argv = _argv(files, "nusc") + ["--inv_steps", "1", "--max_num_samples", "2",
                                   "--root_path", str(tmp_path), "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, files, tmp_path)
        eval_driving.main(argv + ["--init_pose_type", "external", "--external_pose_file",
                                  pose_file])
        got = _report(tmp_path / "reports" / "eval_nusc" / "report.npz")
        assert got["step0/rot_error"].shape == (2,)
        assert (got["step0/rot_error"] < 0.05).all() and (got["step0/trans_error"] < 1e-3).all()
        pnp_poses, known_k = [], tpnp.compute_pose_pnp_known_k

        def record(*args):
            w2c, err = known_k(*args)
            pnp_poses.append(w2c)
            return w2c, err

        mp.setattr(tpnp, "compute_pose_pnp_known_k", record)
        eval_driving.main(argv)
        mp.setattr(tpnp, "compute_pose_pnp_known_k", known_k)
        got = _report(tmp_path / "reports" / "eval_nusc" / "report.npz")
        assert all(v.shape == (2,) and np.isfinite(v).all() for k, v in got.items()
                   if k.startswith("step"))
        mp.setattr(_PortSynthEncoder, "mask_scale", 0.5)
        stats = eval_driving.main(argv)
    assert stats["objects"] == 0 and len(stats["parts_ms"]["first_guess"]) == 0
    assert not [k for k in _report(tmp_path / "reports" / "eval_nusc" / "report.npz")
                if k.startswith("step")]
    jds = jnusc.NuScenesDrivingDataset(str(files["root"] / "nusc"), info["version"],
                                       img_size=RES, index_file=info["index_file"])
    coords = SYN_COORDS * (get_dataset_config("nusc").scene_range / jax_eval.P3D_SCENE_RANGE)
    solve = jax.jit(jpnp.compute_pose_pnp_known_k)
    assert len(pnp_poses) == 2
    for i, pose in enumerate(pnp_poses):
        want, _ = solve(jnp.asarray(coords), jnp.asarray(SYN_MASK),
                        jnp.asarray(jds[i]["K"])[None])
        np.testing.assert_allclose(pose.numpy(), np.asarray(want), rtol=0, atol=POSE_TOL)
