"""The port's driving evaluation and demo (eval_driving.py, demo_driving.py
in nerf_from_image_tpu_torch) against the JAX package's, end to end on the
CPU, on synthetic trees from data/driving_fixtures.py.

Both packages read the same files: tests/test_torch_invert_driver.py's
tiny reference `.pth` generator and LPIPS weights, and a `.pth` encoder of
tests/test_torch_encoder.py's small MiT. As in that file, the packages'
random streams are taken out of play in both (`average_w` patched to one
array, no sampling jitter in the refinement renders, the `mse` loss), the
generator's box is 1e-4 wider than the render's in both, and the port runs
with cv2 hidden (its path on the card), the JAX package with cv2.putText
hidden (its data layer resizes with cv2): the composites carry no text. The
encoder's coordinate and mask heads are replaced in both by one synthetic
map of a known camera, so that PnP is well posed (on a random network's
map it is not: tests/test_torch_pnp.py); its w is the network's.

Three JAX runs, each held against one port run: eval_driving on the
nuScenes tree (2 cars x 2 views: the cross-view columns; PnP from the
encoder over the p3d focal guesses, `--init_pose_type pnp_focal_search`;
demo composites), on the KITTI tree (the ground-truth pose, the average
w's layers collapsed to one w, `--inv_no_split`, the random-rotation novel
view with its NaN image columns and the reprojected LiDAR depth error),
and demo_driving
on one nuScenes frame (the encoder and known-K PnP, the default start of
eval_driving too; the 'labels' Mask-RCNN schema; the JAX driver's own
test covers 'classes'). Reports are held elementwise at rtol 1e-4 and atol
1e-6, but SSIM (1e-4 of its largest value), the rotation error (0.005
degrees: an arccos near 1) and the translation error (1e-4 m: f32 ulps of
a camera tens of metres away), as in the inversion driver's test. The
KITTI run and the demo are in tests/test_torch_driving_{kitti,demo}.py
(each file one JAX run, to keep a file's time near a minute on one core),
with the port-only runs of the external (SUP-NeRF) pose and the
empty-mask skip; the requests the port refuses are here.
"""

import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import nerf_from_image_tpu.engine.inversion as jinv
import nerf_from_image_tpu.models.encoder as jenc_mod
import nerf_from_image_tpu.models.generator as jgen_mod
import nerf_from_image_tpu.models.lpips as jlpips
import nerf_from_image_tpu_torch.engine.inversion as tinv
import nerf_from_image_tpu_torch.models.encoder as tenc_mod
import nerf_from_image_tpu_torch.models.generator as tgen_mod
from nerf_from_image_tpu_torch import demo_driving, eval_driving
from nerf_from_image_tpu_torch.data import driving_fixtures
from nerf_from_image_tpu_torch.utils import weights
from tests.test_torch_encoder import DEPTHS, encoder_pair
from tests.test_torch_generator import (  # noqa: F401
    built_once,
    release_memory,
    seeded_generator_variables,
)
from tests.test_torch_hybrid import _lpips_pair
from tests.test_torch_invert_driver import (
    _jax_init_layout,
    _jax_lpips_from_file,
    _report,
    _tiny_jax_generator,
    _tiny_port_generator,
)
from tests.test_torch_lpips import _lpips_package_state

TOL, ATOL = 1e-4, 1e-6
# SSIM: 1e-4 of its largest value, 1 (E[x^2] - E[x]^2 in f32 on near-white
# windows over c2 = 9e-4: ~eps / c2 = 7e-5).
SSIM_ATOL = 1e-4
ROT_ATOL_DEG, TRANS_ATOL_M = 5e-3, 1e-4
# Composite panels ([-1, 1]): 1e-4; the normals panel 1e-3 (a normalized
# SDF gradient turns where the gradient is short).
PANEL_ATOL, NORMALS_PANEL_ATOL = 1e-4, 1e-3
RES, STEPS = 32, 2  # the MiT encoder takes 32^2 and more
COMMON = ["--resolution", str(RES), "--latent_dim", "64", "--inv_loss", "mse",
          "--inv_steps", str(STEPS), "--query_chunk", "0"]
_JaxGenerator, _PortGenerator = jgen_mod.Generator, tgen_mod.Generator
_JaxEncoder, _PortEncoder = jenc_mod.BootstrapEncoder, tenc_mod.BootstrapEncoder


def _synthetic_maps(res=RES):
    """A coordinate map and mask as the encoder would give them for a
    curved surface seen by a camera of focal 3 (the near cars' crops' focal
    is ~3.1, the far cars' ~17): [1, res, res, 3], [1, res, res]."""
    u = np.arange(res) / res - 0.5
    uu, vv = np.meshgrid(u, u)
    z = 4.0 + 0.6 * uu + 0.3 * vv + 2.0 * (uu ** 2 + vv ** 2)
    cam = np.stack((uu * z / 3.0, vv * z / 3.0, z), -1)
    c, s = np.cos(0.4), np.sin(0.4)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    world = (cam - [0.1, -0.05, 4.2]) @ rot
    mask = (uu ** 2 + vv ** 2 < 0.16).astype(np.float32)
    return world[None].astype(np.float32) / 2.2, mask[None]


SYN_COORDS, SYN_MASK = _synthetic_maps()


class _JaxSynthEncoder(_JaxEncoder):
    # The .pth file replaces every variable: no JAX initialization to run.
    init = _jax_init_layout

    @nn.compact
    def __call__(self, x, deterministic=True):
        _, _, w = super().__call__(x, deterministic)
        b = x.shape[0]
        return (jnp.broadcast_to(SYN_COORDS, (b,) + SYN_COORDS.shape[1:]),
                jnp.broadcast_to(SYN_MASK, (b,) + SYN_MASK.shape[1:]), w)


class _PortSynthEncoder(_PortEncoder):
    mask_scale = 1.0

    def forward(self, x):
        _, _, w = super().forward(x)
        b = x.shape[0]
        return (torch.from_numpy(SYN_COORDS).expand(b, -1, -1, -1),
                torch.from_numpy(SYN_MASK * self.mask_scale).expand(b, -1, -1), w)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The shared inputs: the trees, the generator, encoder and LPIPS
    `.pth` files, and the average w both drivers start from; built once a
    session (the KITTI and demo files share them)."""
    return built_once(tmp_path_factory, "driving_files", _build_files)


def _build_files(root):
    jm = _tiny_jax_generator(latent_dim=64, scene_range=3.0, attention_values=10)
    sd = weights.state_dict_from_jax(seeded_generator_variables(jm, 7))
    torch.save({"model_ema": sd}, root / "g.pth")
    _, enc_vars, _ = encoder_pair()
    torch.save({"model_coord": weights.encoder_state_dict_from_jax(enc_vars)}, root / "c.pth")
    torch.save(_lpips_package_state(_lpips_pair()[1]), root / "vgg.pth")
    nusc = driving_fixtures.build_nusc_tree(str(root / "nusc"), 320, 180, lidar_points=6800,
                                            label_schema="labels")
    driving_fixtures.build_kitti_tree(str(root / "kitti"), width=414, height=125,
                                      lidar_points=20000)
    z_avg = (np.random.default_rng(3).standard_normal((1, jm.num_ws, 64)) * 0.3
             ).astype(np.float32)
    return {"root": root, "generator": str(root / "g.pth"), "encoder": str(root / "c.pth"),
            "lpips": str(root / "vgg.pth"), "nusc": nusc, "z_avg": z_avg}


def _argv(files, dataset, encoder=True):
    argv = ["--dataset", dataset, "--resume_from", files["generator"]] + COMMON
    if encoder:
        argv += ["--coord_resume_from", files["encoder"]]
    if dataset == "nusc":
        return argv + ["--nusc_data_dir", str(files["root"] / "nusc"),
                       "--driving_index_file", files["nusc"]["index_file"]]
    return argv + ["--kitti_data_dir", str(files["root"] / "kitti"), "--max_num_samples", "2"]


def _port_env(mp, files, cwd, record=None):
    """The port's drivers on the CPU with the tiny generator, the synthetic
    encoder, the shared LPIPS weights and average w, no jitter and no cv2;
    `record` collects the rows of every saved composite."""
    mp.chdir(cwd)
    mp.setenv("NFI_LPIPS_WEIGHTS", files["lpips"])
    mp.setitem(sys.modules, "cv2", None)
    mp.setattr(tgen_mod, "Generator", _tiny_port_generator)
    mp.setattr(_PortGenerator, "average_w", lambda self, generator=None, n_samples=10000:
               torch.from_numpy(files["z_avg"]))
    mp.setattr(tenc_mod, "BootstrapEncoder",
               lambda *a, **kw: _PortSynthEncoder(*a, backbone_depths=DEPTHS, **kw))
    render = tinv.render
    mp.setattr(tinv, "render", lambda *a, **kw: render(*a, **{**kw, "generator": None}))
    if record is not None:
        from nerf_from_image_tpu_torch.utils import images as timages

        for module in (timages, demo_driving):
            save = module.save_image_grid
            mp.setattr(module, "save_image_grid",
                       lambda rows, path, save=save: (record.append((path, rows)),
                                                      save(rows, path)))


def _no_put_text(*args, **kwargs):
    raise ImportError("cv2.putText hidden: the composite keeps its float panels")


def _jax_run(files, cwd, script, argv, record):
    """The JAX package's eval_driving.py or demo_driving.py main() in
    `cwd`, patched as _port_env patches the port."""
    import demo_driving as jax_demo
    import eval_driving as jax_eval
    from nerf_from_image_tpu.utils import images as jimages

    module = {"eval_driving": jax_eval, "demo_driving": jax_demo}[script]
    cwd.mkdir(parents=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setenv("NFI_LPIPS_WEIGHTS", files["lpips"])
        # The JAX data layer resizes with cv2; its composites take their
        # no-cv2 branch (no text), as the port's without cv2 do.
        mp.setattr(cv2, "putText", _no_put_text)
        mp.setattr(jgen_mod, "Generator", _tiny_jax_generator)
        mp.setattr(_JaxGenerator, "init", _jax_init_layout)
        mp.setattr(jlpips, "init_lpips_variables", _jax_lpips_from_file)
        mp.setattr(_JaxGenerator, "average_w",
                   lambda self, key, n_samples=10000, label=None: files["z_avg"])
        mp.setattr(jenc_mod, "BootstrapEncoder",
                   lambda **kw: _JaxSynthEncoder(**kw, backbone_depths=DEPTHS))
        render = jinv.render
        mp.setattr(jinv, "render", lambda *a, **kw: render(*a, **{**kw, "key": None}))
        for owner in (jimages, jax_demo):
            save = owner.save_image_grid
            mp.setattr(owner, "save_image_grid",
                       lambda rows, path, save=save: (record.append((path, rows)),
                                                      save(rows, path)))
        mp.setattr(sys, "argv", [script + ".py"] + argv)
        module.main()
    jax.clear_caches()


def _assert_reports_agree(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if k.endswith("rot_error"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=ROT_ATOL_DEG, err_msg=k)
        elif k.endswith("trans_error"):
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TRANS_ATOL_M, err_msg=k)
        elif k.endswith(("ssim", "ssim_random")):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=SSIM_ATOL, err_msg=k)
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=ATOL, err_msg=k)
        else:
            assert got[k] == v, k


def _assert_composites_agree(got, want, normals_panel=None):
    """Saved composites: the same files, each row's panels ([-1, 1]) within
    PANEL_ATOL of the JAX package's, panel `normals_panel` within
    NORMALS_PANEL_ATOL."""
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, rows), (_, jrows) in zip(got, want):
        for row, jrow in zip(rows, jrows):
            assert len(row) == len(jrow), path
            for i, (a, b) in enumerate(zip(row, jrow)):
                atol = NORMALS_PANEL_ATOL if i == normals_panel else PANEL_ATOL
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                           err_msg=f"{path} panel {i}")


@pytest.fixture(scope="module")
def nusc_runs(files, tmp_path_factory):
    """One JAX and one port eval_driving run on the nuScenes tree: PnP from
    the (synthetic) encoder over the p3d focal guesses, cross-view columns,
    composites; once a session."""
    return built_once(tmp_path_factory, "nusc_runs", lambda root: _nusc_runs(files, root))


def _nusc_runs(files, root):
    argv = _argv(files, "nusc") + ["--inv_export_demo_sample", "--max_num_samples", "2",
                                   "--init_pose_type", "pnp_focal_search"]
    jrows, rows = [], []
    _jax_run(files, root / "jax", "eval_driving", argv + ["--root_path", str(root / "jax")],
             jrows)
    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, files, root, rows)
        stats = eval_driving.main(argv + ["--root_path", str(root / "port"), "--device", "cpu"])
    return {"jax": _report(root / "jax" / "reports" / "eval_nusc" / "report.npz"),
            "port": _report(root / "port" / "reports" / "eval_nusc" / "report.npz"),
            "jax_rows": jrows, "rows": rows, "stats": stats, "root": root}


def test_nusc_report_matches_jax(nusc_runs):
    """Every metric of the first two annotations (the near and the far car
    of the first view) at steps 0 and 2, cross-view columns included; the
    first guess is PnP's pose and focal from the focal-guess table (the
    rotation error at step 0 is not 0, and the focal, held fixed, sets
    every render) and the refinement moved it."""
    import eval_driving as jax_eval

    np.testing.assert_array_equal(eval_driving.P3D_FOCAL_GUESSES, jax_eval.P3D_FOCAL_GUESSES)
    want, got = nusc_runs["jax"], nusc_runs["port"]
    names = {k.split("/")[1] for k in want}
    assert names == {"psnr", "ssim", "lpips", "rot_error", "trans_error", "depth_error",
                     "psnr_random", "ssim_random", "lpips_random", "depth_error_random"}
    assert all(v.shape == (2,) and np.isfinite(v).all() for v in want.values()
               if v.dtype.kind == "f")
    assert (want["step0/rot_error"] > 1.0).all()
    assert not np.allclose(want["step2/rot_error"], want["step0/rot_error"])
    _assert_reports_agree(got, want)
    stats = nusc_runs["stats"]
    assert stats["objects"] == 2 and stats["steps"] == STEPS
    # The run's last object writes the report checkpoint too (every 20).
    checkpoint = _report(nusc_runs["root"] / "port" / "reports" / "eval_nusc"
                         / "report_checkpoint.npz")
    assert checkpoint.keys() == got.keys()
    assert [len(stats["parts_ms"][k]) for k in ("data", "first_guess", "eval", "refine")] \
        == [2, 2, 4, 2]


def test_nusc_composites_match_jax(nusc_runs):
    """The per-object composites: input | coords | recon | depth | cross-view
    truth | cross-view recon | cross-view depth."""
    rows = nusc_runs["rows"]
    assert len(rows) == 2 and all(r[1][0][0].shape == (RES, 7 * RES, 3) for r in rows)
    _assert_composites_agree(rows, nusc_runs["jax_rows"])
    from nerf_from_image_tpu_torch.utils.images import read_png

    png = read_png(str(nusc_runs["root"] / rows[0][0]))
    assert png.shape == (RES, 7 * RES, 3)


@pytest.mark.parametrize("request_kind", ["orbax", "orbax_encoder", "chips", "multihost",
                                          "no_card", "dataset", "demo_frame"])
def test_unported_requests_raise(request_kind, files, tmp_path, monkeypatch):
    """Orbax checkpoints and more than one device raise, naming ROADMAP.md
    section 1 item 8; without --device cpu the drivers need a card; an
    unknown dataset or frame raises. None falls back silently."""
    _port_env(monkeypatch, files, tmp_path)
    argv = _argv(files, "nusc") + ["--root_path", str(tmp_path), "--device", "cpu"]
    main, match, error = eval_driving.main, "ROADMAP.md section 1 item 8", NotImplementedError
    if request_kind == "orbax":
        argv += ["--resume_from", str(tmp_path)]
    elif request_kind == "orbax_encoder":
        argv += ["--coord_resume_from", str(tmp_path)]
    elif request_kind == "chips":
        argv += ["--chips", "2"]
    elif request_kind == "multihost":
        argv += ["--multihost"]
        main = demo_driving.main
    elif request_kind == "no_card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is valid")
        argv = argv[:-2]
        match, error = "device='cpu'", RuntimeError
    elif request_kind == "dataset":
        argv += ["--dataset", "p3d_car"]
        match, error = "nusc, kitti or waymo", ValueError
    else:
        argv += ["--inv_manual_input_path", "missing.png"]
        main, match, error = demo_driving.main, "missing.png not found", FileNotFoundError
    with pytest.raises(error, match=match):
        main(argv)
    assert not (tmp_path / "reports").exists()
