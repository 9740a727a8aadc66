"""The port's inversion driver (nerf_from_image_tpu_torch/invert.py::main)
against the JAX package's (invert.py::main), and its reference-checkpoint
readers against the JAX package's.

Both drivers read the same files: a reference `.pth` generator (the tiny
generator of tests/test_inversion.py, with the reference's
`resample_filter` buffers in the file) and an `lpips`-package VGG16
state dict named by NFI_LPIPS_WEIGHTS. The two packages draw their
random streams differently, so the parity run takes them out of play in
both: `average_w` is patched to return one array, the refinement renders
are made deterministic (no sampling jitter) and the loss is 'mse'. The
generator's box is 1e-4 wider than the render's, in both packages (as
tests/test_torch_render.py pulls the render's in): on the box face, where
each ray's first sample lies, the out-of-box test flips with one ulp and
a random generator's flat density makes that a 1% change of the pixel.
One JAX run with `--chips 1` (16 images of 16^2, batches of 6: the size
of tests/test_inversion.py's driver test, which keeps this file's CPU
time in its budget) is held against two port runs: the first 8 images
from the start, and the last 8 resumed from a report checkpoint of the
first 8 that the JAX package's InversionReport wrote (each ends in a
ragged batch of 2). Every array of the port's reports is within 1e-4 of
JAX's, relative to its largest value (the criterion of the port's other
metric tests: SSIM's variance, E[x^2] - E[x]^2 over near-white windows,
differs by ~1e-4 between the two packages' convolutions on the very same
images), and the rotation error within 0.005 degrees (an arccos near 0:
one f32 ulp of the cosine moves it ~0.001 degrees at 1 degree). The
rest runs on the port
only: an encoder first guess (the mask logit held low, so every pose is
PnP's dummy pose) with the demo composite, one default 'vgg' step, the
report's FIDs, and the requests the port refuses.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import nerf_from_image_tpu.engine.inversion as jinv
import nerf_from_image_tpu.models.generator as jgen_mod
import nerf_from_image_tpu.models.lpips as jlpips
import nerf_from_image_tpu_torch.engine.evaluate as teval
import nerf_from_image_tpu_torch.engine.inversion as tinv
import nerf_from_image_tpu_torch.models.encoder as tenc_mod
import nerf_from_image_tpu_torch.models.generator as tgen_mod
from nerf_from_image_tpu.engine.evaluate import InversionReport as JaxReport
from nerf_from_image_tpu.models.encoder import encoder_rename
from nerf_from_image_tpu.utils import images as jimages
from nerf_from_image_tpu.utils import torch_interop
from nerf_from_image_tpu_torch import invert as tinvert
from nerf_from_image_tpu_torch.utils import images as timages
from nerf_from_image_tpu_torch.utils import weights
from tests.test_torch_encoder import DEPTHS
from tests.test_torch_generator import (  # noqa: F401
    built_once,
    release_memory,
    seeded_generator_variables,
)
from tests.test_torch_hybrid import _encoder_pair, _lpips_pair
from tests.test_torch_lpips import _lpips_package_state

TOL, ATOL = 1e-4, 1e-6
ROT_ATOL_DEG = 5e-3
# tests/test_inversion.py's tiny generator.
TINY = dict(w_dim=64, plane_channels=8, synthesis_resolution=16, channel_base=512,
            channel_max=64)
ARGV = ["--dataset", "synthetic", "--resolution", "16", "--batch_size", "24",
        "--max_images", "16", "--latent_dim", "64", "--inv_loss", "mse", "--inv_steps", "2",
        "--query_chunk", "0"]
STEPS = (0, 2)


def _tiny_jax_generator(**kw):
    return _JaxGenerator(**{**kw, **TINY, "scene_range": kw["scene_range"] * (1 + 1e-4)})


def _tiny_port_generator(**kw):
    return _PortGenerator(**{**kw, **TINY, "scene_range": kw["scene_range"] * (1 + 1e-4)})


_JaxGenerator, _PortGenerator = jgen_mod.Generator, tgen_mod.Generator


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The shared inputs: generator .pth (with resample_filter entries),
    encoder .pth (DataParallel 'module.' prefixes), LPIPS weights, the
    JAX generator's variables and the average w both drivers start from;
    built once a session."""
    return built_once(tmp_path_factory, "invert_files", _build_files)


def _build_files(root):
    jm = _tiny_jax_generator(latent_dim=64, scene_range=0.55, attention_values=10)
    variables = seeded_generator_variables(jm, 7)
    sd = weights.state_dict_from_jax(variables)
    sd["synthesis_network.b8.resample_filter"] = torch.ones(4, 4)
    sd["synthesis_network.b16.conv0.resample_filter"] = torch.ones(4, 4)
    torch.save({"model_ema": sd, "model": {}}, root / "g_synthetic.pth")
    _, enc_vars, _ = _encoder_pair()
    enc_sd = weights.encoder_state_dict_from_jax(enc_vars)
    torch.save({"model_coord": {"module." + k: v for k, v in enc_sd.items()}},
               root / "c_synthetic.pth")
    torch.save(_lpips_package_state(_lpips_pair()[1]), root / "vgg.pth")
    z_avg = (np.random.default_rng(3).standard_normal((1, jm.num_ws, 64)) * 0.3
             ).astype(np.float32)
    return {"root": root, "generator": str(root / "g_synthetic.pth"),
            "encoder": str(root / "c_synthetic.pth"), "lpips": str(root / "vgg.pth"),
            "variables": variables, "enc_vars": enc_vars, "z_avg": z_avg}


def _port_env(monkeypatch, files, tmp_path, deterministic=True):
    """The port's driver on the CPU with the tiny generator, the small
    encoder, the shared LPIPS weights and average w; cwd is tmp_path."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("NFI_LPIPS_WEIGHTS", files["lpips"])
    monkeypatch.delenv("NFI_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setattr(tgen_mod, "Generator", _tiny_port_generator)
    monkeypatch.setattr(_PortGenerator, "average_w",
                        lambda self, generator=None, n_samples=10000:
                        torch.from_numpy(files["z_avg"]))
    monkeypatch.setattr(tenc_mod, "BootstrapEncoder",
                        lambda *a, **kw: _PortEncoder(*a, backbone_depths=DEPTHS, **kw))
    if deterministic:
        render = tinv.render
        monkeypatch.setattr(tinv, "render",
                            lambda *a, **kw: render(*a, **{**kw, "generator": None}))


_PortEncoder = tenc_mod.BootstrapEncoder


def _port_main(argv, files, root):
    return tinvert.main(ARGV + ["--resume_from", files["generator"], "--root_path", str(root),
                                "--device", "cpu"] + argv)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _report(path):
    with np.load(str(path)) as data:
        return {k: data[k] for k in data.files}


def _jax_init_layout(self, rngs, *args, method=None, **kw):
    """The generator's init as zeros in its layout: the .pth file replaces
    every variable (state_dict_to_variables is strict), so JAX's
    initialization (a compile of seconds on the CPU) would not reach the
    run."""
    layout = jax.eval_shape(
        lambda k: nn.Module.init(self, k, *args, method=method, **kw), rngs)
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), layout)


def _jax_lpips_from_file(model, key, resolution, weights_path=None):
    """init_lpips_variables with the layout taken from the abstract init:
    NFI_LPIPS_WEIGHTS replaces every variable, so JAX's initialization of
    VGG16 (seconds on the CPU) would not reach the run."""
    zeros = jnp.zeros((1, resolution, resolution, 3))
    layout = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(model.init, key, zeros, zeros))
    state = torch_interop.load_torch_checkpoint(os.environ["NFI_LPIPS_WEIGHTS"])
    return jax.tree.map(jnp.asarray, jlpips.lpips_state_to_variables(layout, state))


def _jax_report(files, root):
    """invert.py::main of the JAX package on one device: its report.npz."""
    import invert as jax_driver

    root.mkdir(parents=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("NFI_LPIPS_WEIGHTS", files["lpips"])
        mp.delenv("NFI_INCEPTION_WEIGHTS", raising=False)
        mp.setattr(jgen_mod, "Generator", _tiny_jax_generator)
        mp.setattr(_JaxGenerator, "init", _jax_init_layout)
        mp.setattr(jlpips, "init_lpips_variables", _jax_lpips_from_file)
        mp.setattr(_JaxGenerator, "average_w",
                   lambda self, key, n_samples=10000, label=None: files["z_avg"])
        render = jinv.render
        mp.setattr(jinv, "render", lambda *a, **kw: render(*a, **{**kw, "key": None}))
        mp.setattr(sys, "argv", ["invert.py", "--chips", "1", "--resume_from",
                                 files["generator"], "--root_path", str(root)] + ARGV)
        jax_driver.main()
    jax.clear_caches()
    return _report(root / "reports" / "inv_synthetic" / "report.npz")


def test_generator_reader_gives_the_jax_readers_weights(files):
    """load_reference_generator against JAX's state_dict_to_variables on
    the same file; both strict: a missing or unused entry raises, a size
    that differs raises, a reshape of the same size passes."""
    sd = torch_interop.load_torch_checkpoint(files["generator"], key="model_ema")
    want = weights.state_dict_from_jax(
        torch_interop.state_dict_to_variables(
            jax.tree.map(np.zeros_like, files["variables"]), sd))
    model = _tiny_port_generator(latent_dim=64, scene_range=0.55, attention_values=10,
                                 device="cpu")
    weights.load_reference_generator(model, files["generator"])
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

    full = weights.load_torch_checkpoint(files["generator"], key="model_ema")
    key = "mapping_network.backbone.fc0.weight"
    for change, error in ((lambda d: d.pop(key), KeyError),
                          (lambda d: d.update(extra=torch.zeros(1)), KeyError),
                          (lambda d: d.update({key: d[key][:, :-1]}), ValueError),
                          (lambda d: d.update({key: d[key].reshape(-1)}), None)):
        bad = dict(full)
        change(bad)
        if error is None:
            model.load_state_dict(weights.reference_state_dict(model, bad))
            assert torch.equal(model.state_dict()[key], full[key])
        else:
            with pytest.raises(error):
                weights.reference_state_dict(model, bad)


def test_encoder_reader_gives_the_jax_readers_weights(files):
    """load_reference_encoder ('model_coord', 'module.' dropped) against
    JAX's state_dict_to_variables with encoder_rename on the same file."""
    sd = torch_interop.load_torch_checkpoint(files["encoder"], key="model_coord")
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    want = weights.encoder_state_dict_from_jax(torch_interop.state_dict_to_variables(
        jax.tree.map(np.zeros_like, files["enc_vars"]), sd, rename=encoder_rename))
    encoder = _PortEncoder(64, backbone_depths=DEPTHS, device="cpu")
    weights.load_reference_encoder(encoder, files["encoder"])
    got = encoder.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_driver_report_matches_jax_from_the_start_and_resumed(files, tmp_path, monkeypatch):
    """Metrics and recovered ws/R/s/t2 at steps 0 and 2 of all 16 images
    (the padded rows of the ragged batches dropped) against the JAX run:
    the first 8 from a port run that starts at image 0, the last 8 from a
    port run that resumes at image 8 from the JAX report's first 8 rows
    and keeps those rows as they were saved."""
    want = _jax_report(files, tmp_path / "jax")
    assert len(want) == 16 and all(len(v) == 16 for v in want.values())
    assert {k.split("/")[1] for k in want} == {"psnr", "ssim", "lpips", "rot_error", "ws",
                                               "R", "s", "t2"}
    _port_env(monkeypatch, files, tmp_path)
    stats = _port_main(["--max_num_samples", "8"], files, tmp_path / "start")
    assert stats["images"] == 8 and len(stats["parts_ms"]["refine"]) == 2
    start = _report(tmp_path / "start" / "reports" / "inv_synthetic" / "report.npz")

    saved = JaxReport(list(STEPS))
    for step in STEPS:
        rows = {k.split("/")[1]: v[:8] for k, v in want.items() if k.startswith(f"step{step}/")}
        saved.add(step, rows, {k: rows.pop(k) for k in ("ws", "R", "s", "t2")})
    saved.save(str(tmp_path / "resumed" / "reports" / "inv_synthetic" / "report_checkpoint"))
    stats = _port_main([], files, tmp_path / "resumed")
    assert stats["images"] == 8 and len(stats["parts_ms"]["refine"]) == 2
    resumed = _report(tmp_path / "resumed" / "reports" / "inv_synthetic" / "report.npz")

    assert start.keys() == resumed.keys() == want.keys()
    for k, v in want.items():
        assert start[k].shape == v[:8].shape and resumed[k].shape == v.shape, k
        np.testing.assert_array_equal(resumed[k][:8], v[:8], err_msg=k)
        got = np.concatenate((start[k], resumed[k][8:]))
        if k.endswith("rot_error"):
            np.testing.assert_allclose(got, v, rtol=0, atol=ROT_ATOL_DEG, err_msg=k)
        elif k.endswith("ssim"):
            assert _rel(got, v) < TOL, (k, _rel(got, v))
        else:
            np.testing.assert_allclose(got, v, rtol=TOL, atol=ATOL, err_msg=k)
    assert not np.allclose(want["step2/ws"], want["step0/ws"])


@pytest.fixture(scope="module")
def demo_run(files, tmp_path_factory):
    """One port run with the encoder, the default loss (crop-augmented
    LPIPS, the renders' own sampling jitter) for one step and the demo
    composite: (first guesses, demo grids, report rows, cwd), once a
    session. The encoder needs 32^2 images (MiT's stage-1 reduction)."""
    return built_once(tmp_path_factory, "invert_demo_run", lambda root: _demo_run(files, root))


def _demo_run(files, root):
    guesses, grids, rows = [], [], []
    first_guess, save = tinvert.first_guess, timages.save_image_grid

    def record_guess(encoder, target_img, *args, **kw):
        guesses.append((encoder, target_img, first_guess(encoder, target_img, *args, **kw)))
        return guesses[-1][-1]

    def record_grid(panels, path):
        grids.append((panels, path))
        return save(panels, path)

    add = teval.InversionReport.add

    def record_rows(self, step, metrics, recovered):
        rows.append((step, {**metrics, **recovered}))
        return add(self, step, metrics, recovered)

    with pytest.MonkeyPatch.context() as mp:
        _port_env(mp, files, root, deterministic=False)
        mp.setattr(tinvert, "first_guess", record_guess)
        mp.setattr(timages, "save_image_grid", record_grid)
        mp.setattr(teval.InversionReport, "add", record_rows)
        argv = [a for a in ARGV if a not in ("--inv_loss", "mse")]
        tinvert.main(argv + ["--resume_from", files["generator"], "--root_path", str(root),
                             "--device", "cpu", "--coord_resume_from", files["encoder"],
                             "--inv_export_demo_sample", "--inv_steps", "1",
                             "--max_images", "4", "--batch_size", "8", "--resolution", "32"])
    return guesses, grids, rows, root


def test_encoder_first_guess_and_demo_composite(demo_run):
    """With the encoder every first guess is PnP's dummy pose (no pixel
    passes the 0.9 mask threshold) and z0 the encoder's w over lr_gain_z;
    the demo composite of the first (shuffled) batch is the pixels JAX's
    save_image_grid writes for the same panels."""
    guesses, grids, _, root = demo_run
    (encoder, target, (z0, pose0)), = guesses
    with torch.no_grad():
        _, mask, w = encoder(target[..., :3])
    assert float(mask.max()) < 0.9
    torch.testing.assert_close(z0, w.expand(2, z0.shape[1], 64) / 5.0, rtol=0, atol=0)
    cam, _ = tinv.build_camera(pose0, False)
    torch.testing.assert_close(cam, cam[:1].expand_as(cam))
    assert abs(float(torch.linalg.vector_norm(cam[0, :3, 3])) - 10.0) < 1e-4

    (panels, path), = grids
    assert path == os.path.join("outputs", "sample_synthetic_1it.png")
    # target, coordinates, front render and its normals, novel view and its normals
    assert len(panels) == 2 and all(len(r) == 6 for r in panels)
    jimages.save_image_grid(panels, str(root / "jax.png"))
    import imageio.v2 as imageio

    got, want = imageio.imread(root / path), imageio.imread(root / "jax.png")
    assert got.shape == (64, 6 * 32, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timages.read_png(str(root / path)), want)
    assert not (root / "reports" / "inv_synthetic" / "report.npz").exists()


def test_default_vgg_step_is_finite(demo_run):
    """The demo run's step of the default loss: the rows it adds to the
    report at steps 0 and 1 (2 images, metrics and recovered ws/R/s/t2)
    are finite."""
    _, _, rows, _ = demo_run
    assert [step for step, _ in rows] == [0, 1]
    for step, row in rows:
        assert set(row) >= {"psnr", "ssim", "lpips", "rot_error", "ws", "R", "s", "t2"}
        for k, v in row.items():
            assert len(v) == 2 and np.isfinite(v).all(), (step, k)


def test_report_fid_front_and_random(files, tmp_path, monkeypatch):
    """With NFI_INCEPTION_WEIGHTS (tests/test_torch_train.py's stand-in for
    Inception): the evaluations keep the front and novel views'
    activations, and the report's summary gives fid_front and fid_random
    at both steps, the Frechet distances of those activations to the
    train-eval images' statistics."""
    from nerf_from_image_tpu_torch.engine import gan_eval
    from nerf_from_image_tpu_torch.data.loaders import load_dataset
    from nerf_from_image_tpu_torch.metrics import fid
    from tests.test_torch_train import StandInInception, stand_in_inception

    _port_env(monkeypatch, files, tmp_path)
    stand_in_inception(monkeypatch, tmp_path)
    stats = _port_main(["--max_num_samples", "4"], files, tmp_path / "run")
    assert stats["images"] == 4
    report_dir = tmp_path / "run" / "reports" / "inv_synthetic"
    report = _report(report_dir / "report.npz")
    _, _, split, _ = load_dataset("synthetic", "", resolution=16, max_images=16)
    real = gan_eval.compute_real_fid_stats(
        StandInInception(os.environ["NFI_INCEPTION_WEIGHTS"]), split.images, device="cpu")
    summary = (report_dir / "report.txt").read_text().split("[checkpoint step ")[1:]
    for step, text in zip(STEPS, summary):
        lines = dict(line.strip().split(": ") for line in text.splitlines()[1:])
        for view in ("front", "random"):
            acts = report[f"step{step}/inception_activations_{view}"]
            assert acts.shape == (4, 4)
            want = float(fid.frechet_distance(*fid.calculate_stats(
                torch.from_numpy(acts).double()), *real))
            assert np.isfinite(want)
            assert abs(float(lines[f"fid_{view}"]) - want) <= 5e-6 + 1e-5 * abs(want), view


@pytest.mark.parametrize("request_kind", ["chips", "gpus", "orbax", "orbax_encoder",
                                          "no_card", "no_mask"])
def test_unported_requests_raise(request_kind, files, tmp_path, monkeypatch):
    """More than one device and orbax checkpoints raise errors naming their
    ROADMAP.md item; without --device cpu the driver needs a card; a demo
    image without a mask raises the JAX package's error. None falls back
    silently."""
    _port_env(monkeypatch, files, tmp_path)
    argv = ARGV + ["--root_path", str(tmp_path), "--device", "cpu"]
    match, error = "ROADMAP.md section 1 item 8", NotImplementedError
    if request_kind in ("chips", "gpus"):
        argv += [f"--{request_kind}", "2"]
    elif request_kind == "orbax":
        argv += ["--resume_from", str(tmp_path)]
        match = "orbax"
    elif request_kind == "orbax_encoder":
        argv += ["--coord_resume_from", str(tmp_path)]
        match = "orbax"
    elif request_kind == "no_card":
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is valid")
        argv = argv[:-2]
        match, error = "device='cpu'", RuntimeError
    else:
        import imageio.v2 as imageio

        imageio.imwrite(tmp_path / "x.png", np.zeros((8, 8, 3), np.uint8))
        argv += ["--inv_manual_input_path", str(tmp_path / "x.png")]
        match, error = "No mask found", RuntimeError
    with pytest.raises(error, match=match):
        tinvert.main(argv)
    assert not (tmp_path / "reports").exists() or request_kind == "no_mask"
