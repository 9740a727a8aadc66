"""The port's GAN training driver, `python -m nerf_from_image_tpu_torch.train`,
on the CPU at a tiny size (port only).

The driver builds the generator and discriminators at the flags' sizes;
here their widths are cut to tests/test_gan_engine.py::tiny_models'
(planes 3 x 16^2 x 8, w 64, discriminator channels <= 32) by patching the
classes the driver builds. The G step's main render goes through the
splat op in checkpointed chunks of whole image rows, as on the card, and
its plain backward on the CPU.
"""

import functools
import os

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch import train
from nerf_from_image_tpu_torch.engine import gan
from nerf_from_image_tpu_torch.kernels import splat as tsplat
from nerf_from_image_tpu_torch.models import discriminator as tdisc
from nerf_from_image_tpu_torch.models import generator as tgen
from nerf_from_image_tpu_torch.models.stylegan import DiscriminatorBackbone
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt
from nerf_from_image_tpu_torch.utils.weights import load_reference_generator
from tests.test_torch_generator import release_memory  # noqa: F401

TINY_G = dict(w_dim=64, plane_channels=8, synthesis_resolution=16, channel_base=512,
              channel_max=64)
TINY_D = dict(channel_base=512, channel_max=32)
_PortGenerator = tgen.Generator
# 16^2 rays x 64 samples a pass, in 4 chunks of 4 whole image rows (an
# image's points; batches of 2).
CHUNK = 4096
BASE = ["--dataset", "synthetic", "--resolution", "16", "--batch_size", "2",
        "--max_images", "8", "--latent_dim", "64", "--sdf_pretrain_steps", "2",
        "--path_length_regularization", "--plane_splat", "true", "--query_chunk",
        str(CHUNK), "--device", "cpu"]


def _tiny(mp):
    """Patches the driver's models to the tiny widths; returns the list
    that receives the splat op's plane-gradient calls' (ray grid, blocks)."""
    mp.setattr(tgen, "Generator", functools.partial(_PortGenerator, **TINY_G))
    mp.setattr(tdisc, "DiscriminatorBackbone",
               functools.partial(DiscriminatorBackbone, **TINY_D))
    calls = []
    original = tsplat.splat3_backward

    def spy(*args, **kw):
        calls.append(args[4:6])
        return original(*args, **kw)

    mp.setattr(tsplat, "splat3_backward", spy)
    mp.delenv("NFI_INCEPTION_WEIGHTS", raising=False)
    return calls


@pytest.fixture
def tiny(monkeypatch):
    return _tiny(monkeypatch)


def _recorded_steps(mp):
    """Patches the engine's G and D steps to record their metrics (as
    floats, in step order) in the list it returns; the driver itself reads
    them only at print iterations."""
    steps = []
    for name in ("g_step", "d_step"):
        def record(*args, step=getattr(gan, name), **kw):
            metrics = step(*args, **kw)
            steps.append({k: float(v) for k, v in metrics.items()})
            return metrics

        mp.setattr(gan, name, record)
    return steps


def _state(path):
    return ckpt.load_train_checkpoint(path)


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """4 iterations of the driver, and the splat op's calls they made."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _tiny(mp)
        steps = _recorded_steps(mp)
        root = tmp_path_factory.mktemp("first")
        run = train.main(BASE + ["--iterations", "4", "--root_path", str(root)])
    run["losses"] = steps
    return run, calls


def test_resume_equals_the_straight_run_bit_for_bit(first_run, tiny, tmp_path, monkeypatch):
    """4 iterations, a resume to 6, and 6 straight: the same checkpoint
    and the same losses, bit for bit, with no random state saved. Each G
    step hands the splat op 2 passes x 4 chunks; the D steps and the
    regularizers none."""
    first, calls = first_run
    resumed_root, straight_root = str(tmp_path / "a"), str(tmp_path / "b")
    assert len(calls) == 2 * 4 * 2  # two G steps
    assert all(grid == ((4, 16, 64), (16, 16, 4)) for grid in calls)
    assert first["last_checkpoint"].endswith("checkpoint_4.pth")
    steps = _recorded_steps(monkeypatch)
    resumed = train.main(BASE + ["--iterations", "6", "--root_path", resumed_root,
                                 "--resume_from", first["last_checkpoint"]])
    assert len(tiny) == 2 * 4  # one G step
    assert resumed["start_iteration"] == 4 and resumed["pretrain_steps"] == 0
    resumed_losses = steps[:]
    del steps[:]
    straight = train.main(BASE + ["--iterations", "6", "--root_path", straight_root])
    straight_losses = steps[:]
    del steps[:]
    assert straight_losses[4:] == resumed_losses
    assert first["losses"] == straight_losses[:4]
    assert straight["metrics"] == {"g": straight_losses[4], "d": straight_losses[5]}
    _assert_same(_state(resumed["last_checkpoint"]), _state(straight["last_checkpoint"]))
    for m in straight_losses:
        assert all(np.isfinite(v) for v in m.values()), m
    assert {"loss_g", "loss_eikonal", "loss_tv", "loss_entropy", "loss_ppl",
            "grad_norm_g"} <= set(straight_losses[0])
    assert {"loss_d_real", "loss_d_fake", "loss_r1", "sign_real",
            "augment_p"} <= set(straight_losses[1])
    assert len(straight_losses) == 6 and straight["pretrain_steps"] == 2

    # Without --resume_from the driver finds checkpoint_6.pth, and drops
    # it: the blur warm-up (12,500 iterations) is not over.
    again = train.main(BASE + ["--iterations", "2", "--root_path", straight_root])
    assert again["start_iteration"] == 0 and steps == straight_losses[:2]


def test_checkpoint_loads_into_the_inversion_driver(first_run, tiny, tmp_path):
    """A train checkpoint's 'model_ema' is read by load_reference_generator
    and by the inversion driver (through --run_inversion, which hands the
    command line over)."""
    root = str(tmp_path)
    run, _ = first_run
    state = _state(run["last_checkpoint"])
    model = tgen.Generator(latent_dim=64, scene_range=1.0, attention_values=10, device="cpu")
    load_reference_generator(model, run["last_checkpoint"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, state["model_ema"][k]), k
    assert not torch.equal(state["model_ema"]["decoder.net.0.weight"],
                           state["model"]["decoder.net.0.weight"])
    cwd = os.getcwd()
    os.chdir(root)
    try:
        # One inversion batch of all 8 images (batch_size // 4).
        stats = train.main(BASE + ["--run_inversion", "--resume_from", run["last_checkpoint"],
                                   "--inv_steps", "1", "--inv_loss", "mse",
                                   "--batch_size", "32", "--root_path", root])
    finally:
        os.chdir(cwd)
    with np.load(os.path.join(stats["report_dir"], "report.npz")) as report:
        assert np.isfinite(report["step1/psnr"]).all()


@pytest.mark.parametrize("request_kind", ["chips", "orbax"])
def test_unported_requests_raise(request_kind, tiny, tmp_path, monkeypatch):
    """A --chips that disagrees with the launcher's group raises, and so
    does an orbax checkpoint."""
    argv = BASE + ["--iterations", "2", "--root_path", str(tmp_path)]
    if request_kind == "chips":
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", "29500")):
            monkeypatch.setenv(k, v)
        argv += ["--chips", "2"]
        error, match = ValueError, "under a launcher of 1 ranks"
    else:
        orbax = tmp_path / "checkpoint_4"
        orbax.mkdir()
        argv += ["--resume_from", str(orbax)]
        error, match = NotImplementedError, "orbax checkpoint"
    with pytest.raises(error, match=match):
        train.main(argv)
    assert not tiny


class StandInInception(torch.nn.Module):
    """Inception's place in the driver tests: a per-pixel linear map, tanh
    and the mean over H and W (4 features), its weight read from the file
    NFI_INCEPTION_WEIGHTS names."""

    def __init__(self, path, device="cpu"):
        super().__init__()
        self.w = torch.load(path)["w"].to(device)

    def forward(self, x):
        return torch.mean(torch.tanh(x @ self.w), dim=(1, 2))


def stand_in_inception(mp, tmp_path):
    """Points NFI_INCEPTION_WEIGHTS at a stand-in's file and makes the
    drivers load the stand-in from it."""
    from nerf_from_image_tpu_torch.engine import gan_eval

    path = str(tmp_path / "pt_inception.pth")
    torch.save({"w": torch.randn((3, 4), generator=torch.Generator().manual_seed(0))}, path)
    mp.setenv("NFI_INCEPTION_WEIGHTS", path)
    mp.setattr(gan_eval, "load_fid_inception", StandInInception)


def _recorded_logs(mp):
    """Records the driver's TensorBoard scalars {tag: value} and image tags."""
    from nerf_from_image_tpu_torch.utils import tb

    scalars, images = {}, []
    mp.setattr(tb.Logger, "scalar",
               lambda self, tag, value, step: scalars.__setitem__(tag, float(value)))
    mp.setattr(tb.Logger, "images", lambda self, tag, value, step: images.append(tag))
    return scalars, images


# The scalars of the JAX driver's encoder-mode evaluation (train.py:441-477)
# on the synthetic dataset: RGB images (no IoU), one view an object (no
# scored random view) and a test split, with Inception weights.
ENCODER_EVAL = ({f"reconstruction/{m}{s}_front" for m in ("psnr", "ssim", "lpips")
                 for s in ("", "_test")}
                | {f"reconstruction/fid_{v}view{s}" for v in ("front", "random")
                   for s in ("", "_test")})


@pytest.mark.parametrize("mode", ["generation", "use_encoder"])
def test_train_time_evaluation(mode, tiny, tmp_path, monkeypatch):
    """With Inception weights, two iterations and an evaluation: the
    generation FID ('fid', 'generation/fid_untrunc'), or under
    --use_encoder the JAX driver's reconstruction scalars, the eval image
    grids and a best checkpoint whose best_fid.json a resumed run reads
    back (and keeps while no evaluation beats it)."""
    stand_in_inception(monkeypatch, tmp_path)
    scalars, images = _recorded_logs(monkeypatch)
    argv = BASE + ["--display_every", "2", "--root_path", str(tmp_path)] + (
        ["--use_encoder"] if mode == "use_encoder" else [])
    run = train.main(argv + ["--iterations", "2"])
    fid = run["eval"]["fid"]
    assert np.isfinite(fid) and run["best_fid"] == fid == scalars["fid"]
    assert images == ["img/eval_rgb", "img/eval_depth", "img/eval_mask"]
    if mode == "generation":
        assert set(run["eval"]) == {"fid", "generation/fid_untrunc"}
        assert scalars["generation/fid_untrunc"] == fid
        return
    assert set(run["eval"]) == ENCODER_EVAL | {"fid"}
    assert fid == run["eval"]["reconstruction/fid_randomview"]
    for tag in ENCODER_EVAL:
        assert np.isfinite(scalars[tag]), tag
    best = os.path.join(run["checkpoint_dir"], "best_fid.json")
    assert os.path.exists(os.path.join(run["checkpoint_dir"], "checkpoint_best.pth"))
    with open(best, "w") as f:
        f.write('{"best_fid": 1e-9}')
    resumed = train.main(argv + ["--iterations", "4", "--resume_from", run["last_checkpoint"]])
    assert resumed["start_iteration"] == 2 and resumed["best_fid"] == 1e-9
    assert np.isfinite(resumed["eval"]["fid"])


def test_second_derivative_through_the_splat_op_raises():
    """The splat op's backward is first-order only: the regularizers'
    double backward goes through the grid-sample decode instead."""
    gen = torch.Generator().manual_seed(0)
    planes = torch.randn((1, 3, 8, 8, 4), generator=gen, requires_grad=True)
    coords = torch.rand((1, 32, 3), generator=gen) * 2 - 1
    out = tsplat.triplane_sample_mean(planes, coords)
    (g,) = torch.autograd.grad(torch.sum(out**2), planes, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        torch.sum(g**2).backward()
    # The plane gradient is not connected to the planes at all.
    (g,) = torch.autograd.grad(torch.sum(out**2), planes, create_graph=True)
    with pytest.raises(RuntimeError, match="not have been used"):
        torch.autograd.grad(torch.sum(g**2), planes)


@pytest.mark.parametrize("mode", ["l1", "mse"])
def test_dual_pixel_loss_steps(mode, tiny):
    """The dual l1/mse modes: the conditional discriminator is replaced by
    a pixel loss against the blurred conditioning image (the camera not
    augmented), the D step trains the second discriminator alone, and
    the encoder-conditioned generator's embedding gets gradients."""
    model = tgen.Generator(latent_dim=64, scene_range=0.55, attention_values=0,
                           use_encoder=True, device="cpu")
    disc2 = tdisc.Discriminator(16, 3, False, device="cpu")
    config = gan.GANTrainConfig(batch_size=4, latent_dim=64, white_background=True,
                                use_encoder=True, dual_discriminator=True,
                                dual_l1=mode == "l1", dual_mse=mode == "mse",
                                augment_p=0.5)
    state = gan.init_gan_state(config, model, None, disc2)
    assert state.disc is None and state.opt_d is None
    rc = gan.RenderConfig(resolution=16, depth_samples_per_ray=8, scene_range=0.55,
                          white_background=True)
    gen = torch.Generator().manual_seed(1)
    eye = torch.eye(4).repeat(4, 1, 1)
    eye[:, 2, 3] = 2.5
    batch = {"pose": eye, "focal": torch.full((4,), 1.5),
             "images": torch.rand((4, 16, 16, 3), generator=gen) * 2 - 1}
    emb_before = model.emb.conv1.weight.detach().clone()
    m = gan.g_step(config, rc, state, batch, gen, dict(batch))
    assert {"loss_g", "loss_g_uncond"} <= set(m) and all(torch.isfinite(v) for v in m.values())
    assert not torch.equal(model.emb.conv1.weight, emb_before)
    d_before = [p.detach().clone() for p in disc2.parameters()]
    m = gan.d_step(config, rc, state, batch, dict(batch), gen)
    assert "loss_d_real" not in m and np.isfinite(float(m["loss_r1_uncond"]))
    assert not all(torch.equal(a, b) for a, b in zip(d_before, disc2.parameters()))
    assert float(m["augment_p"]) == pytest.approx(0.5) and state.iteration == 2
