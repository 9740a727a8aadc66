"""Bootstrap-encoder distillation (engine/coord_regressor.py) on the port
against the JAX package, and the port's driver
(`python -m nerf_from_image_tpu_torch.train_encoder`) on the CPU.

One coord_train_step at tiny width (tests/test_torch_gan.py's generator,
tests/test_torch_encoder.py's one-block-a-stage encoder, 32^2 rays, 8 + 8
samples): the JAX step draws z from its key, which the port is handed; the
render runs deterministically in both (the JAX step's render is patched
to key=None), and both packages' module-level `drop_path` take their
keep-masks from one shared list. The JAX step's optimizer is replaced by
one that returns the gradients as its state. Losses and encoder gradients
agree within 1e-4 (relative to the largest value of each). The optimizer
is held to optax.adam with the step schedule on shared gradients across
the drop. The driver tests are port only, at tiny widths patched into the
classes it builds.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_from_image_tpu.engine import coord_regressor as jcr
from nerf_from_image_tpu.engine import render as jrender
from nerf_from_image_tpu.models import segformer as jseg
from nerf_from_image_tpu_torch import invert, train_encoder
from nerf_from_image_tpu_torch.engine import coord_regressor as tcr
from nerf_from_image_tpu_torch.engine.render import RenderConfig
from nerf_from_image_tpu_torch.models import encoder as tenc
from nerf_from_image_tpu_torch.models import generator as tgen
from nerf_from_image_tpu_torch.models import segformer as tseg
from nerf_from_image_tpu_torch.models.encoder import encoder_rename
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt
from nerf_from_image_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax,
    load_reference_encoder,
)
from tests.test_torch_encoder import DEPTHS, encoder_pair
from tests.test_torch_gan import SR_INNER, gen_pair
from tests.test_torch_generator import jax_compiled, release_memory  # noqa: F401

TOL = 1e-4
RES, B = 32, 2
RC_KW = dict(resolution=RES, depth_samples_per_ray=8, scene_range=SR_INNER, query_chunk=None)


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _cameras():
    poses = []
    for angle in (0.2, 0.9):
        c, s = np.cos(angle), np.sin(angle)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        m[:3, 3] = m[:3, :3] @ np.array([0.0, 0.0, 2.0])
        poses.append(m)
    return np.stack(poses), np.full((B,), 1.3, np.float32)


def _keep_masks():
    """The drop-path keep-masks of one encoder forward: one per call with a
    rate above 0 (3 blocks x 2), both values in each, over B samples."""
    return [np.asarray([(i % 2), 1 - (i % 2)], np.float32) for i in range(6)]


def _patch_drop_path(mp, module, masks, to_array):
    """Makes `module.drop_path` take its keep-mask from `masks` in call
    order, with the package's own rescaling by 1 / keep."""
    it = iter(masks)

    def drop_path(x, rate, deterministic, *_):
        if deterministic or rate == 0.0:
            return x
        mask = to_array(next(it)).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return x * mask / (1.0 - rate)

    mp.setattr(module, "drop_path", drop_path)
    return it


# The layers whose outputs meet a ReLU (or the w head's LeakyReLU), in
# groups whose inputs the earlier groups' shifts have settled.
KINKED = (("backbone.linear_pred",), ("post.0", "w_regressor_pre.0"),
          ("post.2", "w_regressor_post.0"), ("w_regressor_post.2",))
JAX_PARAMS = {"backbone.linear_pred": ("backbone", "linear_pred"), "post.0": ("post_0",),
              "post.2": ("post_2",), "w_regressor_pre.0": ("w_regressor_pre_0",),
              "w_regressor_post.0": ("w_regressor_post_0",),
              "w_regressor_post.2": ("w_regressor_post_2",)}


def _clear_shift(values):
    """(shift, margin): a shift of one channel's values that keeps them
    clear of 0: a one-signed channel moves 1e-3 of its spread away from 0
    where it is closer; otherwise 0 goes to the middle of the widest of
    the gaps between its values next to 0. The margin is the distance
    from 0 to the nearest shifted value."""
    x = np.unique(values).astype(np.float64)
    delta = 1e-3 * max(np.ptp(x), np.abs(x).max())
    if x[0] >= 0:
        return max(0.0, delta - x[0]), max(x[0], delta)
    if x[-1] <= 0:
        return min(0.0, -delta - x[-1]), max(-x[-1], delta)
    i = int(np.searchsorted(x, 0.0))
    lo, hi = max(i - 4, 1), min(i + 4, len(x) - 1)
    j = max(range(lo, hi + 1), key=lambda k: x[k] - x[k - 1])
    return -0.5 * (x[j] + x[j - 1]), 0.5 * (x[j] - x[j - 1])


@functools.lru_cache(maxsize=1)
def _encoder_variables():
    """tests/test_torch_encoder.py's encoder variables with the biases in
    front of each ReLU shifted per channel (by less than a few gaps
    between its values) so that no pre-activation of this step lies near
    the kink: an f32 rounding there flips the unit's gradient between the
    packages (a 5e-4 gap in the step's gradients), which says nothing of
    the port. Returns (variables, the smallest margin as a share of each
    channel's spread)."""
    _, _, tm = gen_pair(4)
    pose, focal = _cameras()
    batch = {"pose": torch.from_numpy(pose), "focal": torch.from_numpy(focal)}
    z = torch.from_numpy(np.array(_jax_z()))
    image = tcr.render_targets(tcr.RenderConfig(**RC_KW), tm, batch, z, device="cpu")[0]
    variables = jax.tree.map(np.copy, encoder_pair()[1])
    worst = np.inf
    for group in KINKED:
        encoder = tenc.BootstrapEncoder(64, backbone_depths=DEPTHS, device="cpu")
        encoder.load_state_dict(encoder_state_dict_from_jax(variables), strict=True)
        seen = {}
        for layer in group:
            encoder.get_submodule(layer).register_forward_hook(
                lambda m, i, o, layer=layer: seen.setdefault(layer, o.detach()))
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            _patch_drop_path(mp, tseg, _keep_masks(), torch.from_numpy)
            encoder(image, deterministic=False)
        for layer, out in seen.items():
            if layer == "backbone.linear_pred":
                # The coordinate head takes the ReLU of the 4x upsampled map.
                out = torch.cat((out.flatten(2), tseg._resize_bilinear(
                    out, (4 * out.shape[2], 4 * out.shape[3])).flatten(2)), 2)
            per_channel = (out.transpose(0, 1).reshape(out.shape[1], -1) if out.dim() > 2
                           else out.T).numpy()
            bias = variables["params"]
            for key in JAX_PARAMS[layer]:
                bias = bias[key]
            for c, values in enumerate(per_channel):
                shift, margin = _clear_shift(values)
                bias["bias"][c] += shift
                worst = min(worst, margin / max(np.ptp(values), np.abs(values).max()))
    return variables, worst


@functools.lru_cache(maxsize=1)
def _jax_z():
    return np.asarray(jax.random.normal(jax.random.split(jax.random.key(5), 3)[0], (B, 64)))


@functools.lru_cache(maxsize=1)
def _jax_step():
    """(z, the JAX step's losses, its encoder gradients), both numpy."""
    jm, gvars, _ = gen_pair(4)
    jenc = encoder_pair()[0]
    evars = jax.tree.map(jnp.asarray, _encoder_variables()[0])
    pose, focal = _cameras()
    config = jcr.CoordRegressorConfig(batch_size=B, latent_dim=64)
    key = jax.random.key(5)
    z = _jax_z()

    def capture(_config):
        # Zero updates; the gradients become the returned optimizer state.
        return optax.GradientTransformation(
            lambda params: (), lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcr, "make_optimizer", capture)
        mp.setattr(jcr, "render", lambda *a, key=None, **kw: jrender.render(*a, **kw))
        rest = _patch_drop_path(mp, jseg, _keep_masks(), jnp.asarray)
        state = jcr.CoordTrainState(evars["params"], (), jnp.zeros((), jnp.int32))
        args = (state, {"pose": jnp.asarray(pose), "focal": jnp.asarray(focal)}, key)
        new_state, losses = jax_compiled(lambda s, b, k: jcr.coord_train_step(
            config, jrender.RenderConfig(**RC_KW), jm, gvars, jenc, s, b, k), *args)(*args)
        assert next(rest, None) is None  # every mask used
    grads = {encoder_rename(".".join(str(k.key) for k in path)): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(new_state.opt_state)[0]}
    return z, {k: float(v) for k, v in losses.items()}, grads


def test_coord_train_step_matches_jax(monkeypatch):
    z, want_losses, want_grads = _jax_step()
    variables, margin = _encoder_variables()
    # No ReLU input within a hundred f32 roundings (of its channel's spread)
    # of the kink.
    assert margin > 100 * np.finfo(np.float32).eps
    _, _, tm = gen_pair(4)
    encoder = tenc.BootstrapEncoder(64, backbone_depths=DEPTHS, device="cpu")
    encoder.load_state_dict(encoder_state_dict_from_jax(variables), strict=True)
    config = tcr.CoordRegressorConfig(latent_dim=64)
    opt = tcr.make_optimizer(config, encoder)
    recorded = []
    step = opt.step
    monkeypatch.setattr(opt, "step", lambda grads: (recorded.append(grads), step(grads)))
    rest = _patch_drop_path(monkeypatch, tseg, _keep_masks(), torch.from_numpy)
    pose, focal = _cameras()
    losses = tcr.coord_train_step(
        config, RenderConfig(**RC_KW), tm, encoder, opt,
        {"pose": torch.from_numpy(pose), "focal": torch.from_numpy(focal)},
        z=torch.from_numpy(np.array(z)), device="cpu")
    assert next(rest, None) is None
    assert set(losses) == set(want_losses) == {"loss", "loss_coords", "loss_mask",
                                               "loss_latent"}
    for k, v in want_losses.items():
        assert abs(float(losses[k]) - v) < TOL * abs(v), k
    names = [n for n, _ in encoder.named_parameters()]
    assert set(names) == set(want_grads)
    for name, g in zip(names, recorded[0]):
        assert _rel(g, want_grads[name]) < TOL, name
    assert opt.count == 1


def test_optimizer_matches_optax_across_the_lr_drop():
    """optax.adam(schedule) of the JAX package's make_optimizer on shared
    gradients, six updates with the drop at the third."""
    config = tcr.CoordRegressorConfig(lr=1e-2, lr_drop_at=3)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in p0.items()})
    opt = tcr.make_optimizer(config, module)
    tx = jcr.make_optimizer(jcr.CoordRegressorConfig(lr=1e-2, lr_drop_at=3))
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    for _ in range(6):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(grads[k]) for k in module])
        for k in module:
            assert _rel(module[k], params[k]) < 1e-6, k
    assert opt.count == 6


# ------------------------------------------------------------ the driver

TINY_G = dict(w_dim=64, plane_channels=8, synthesis_resolution=16, channel_base=512,
              channel_max=64)
BASE = ["--dataset", "synthetic", "--resolution", "32", "--batch_size", "1",
        "--max_images", "8", "--latent_dim", "64", "--device", "cpu"]


@pytest.fixture
def tiny(monkeypatch):
    """The driver's generator and encoder at tiny widths, a checkpoint
    every iteration, and a record of every step's losses."""
    monkeypatch.setattr(tgen, "Generator", functools.partial(tgen.Generator, **TINY_G))
    monkeypatch.setattr(tenc, "BootstrapEncoder",
                        functools.partial(tenc.BootstrapEncoder, backbone_depths=DEPTHS))
    monkeypatch.setattr(train_encoder, "SAVE_EVERY", 1)
    steps = []
    step = tcr.coord_train_step

    def record(*args, **kw):
        losses = step(*args, **kw)
        steps.append({k: float(v) for k, v in losses.items()})
        return losses

    monkeypatch.setattr(tcr, "coord_train_step", record)
    return steps


def _tiny_encoder():
    return tenc.BootstrapEncoder(64, device="cpu")


@pytest.mark.parametrize("entry", ["train_encoder", "invert_hand_over"])
def test_resumed_run_equals_the_straight_run(entry, tiny, tmp_path):
    """Two iterations straight, and one more from checkpoint_1: the same
    losses and the same checkpoint_2, bit for bit; its
    'model_coord' loads through load_reference_encoder. `invert
    --inv_train_coord_only` hands the same command line over."""
    main = train_encoder.main if entry == "train_encoder" else (
        lambda argv: invert.main(argv + ["--inv_train_coord_only"]))
    straight = main(BASE + ["--iterations", "2", "--root_path", str(tmp_path / "a")])
    assert straight["start_iteration"] == 0 and len(tiny) == 2
    assert all(np.isfinite(list(s.values())).all() for s in tiny)
    first = list(tiny)
    tiny.clear()
    resumed = main(BASE + ["--iterations", "2", "--root_path", str(tmp_path / "b"),
                           "--coord_resume_from",
                           os.path.join(straight["checkpoint_dir"], "checkpoint_1.pth")])
    assert resumed["start_iteration"] == 1 and tiny == first[1:]
    a = ckpt.load_train_checkpoint(straight["last_checkpoint"])
    b = ckpt.load_train_checkpoint(resumed["last_checkpoint"])
    assert a["iteration"] == b["iteration"] == 2
    assert a["optimizer_coord"]["count"] == 2
    for k, v in a["model_coord"].items():
        assert torch.equal(v, b["model_coord"][k]), k
    encoder = _tiny_encoder()
    load_reference_encoder(encoder, straight["last_checkpoint"])
    for k, v in encoder.state_dict().items():
        assert torch.equal(v, a["model_coord"][k]), k


def test_reference_encoder_warm_starts_the_weights_only(tiny, tmp_path):
    """A reference-format file (only 'model_coord', DataParallel prefixes):
    the run starts at iteration 0 from its weights; with no
    --coord_resume_from the run finds its own newest checkpoint."""
    donor = _tiny_encoder()
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(0.01)
    path = str(tmp_path / "c.pth")
    torch.save({"model_coord": {f"module.{k}": v for k, v in donor.state_dict().items()}},
               path)
    run = train_encoder.main(BASE + ["--iterations", "1", "--root_path", str(tmp_path),
                                     "--coord_resume_from", path])
    assert run["start_iteration"] == 0 and len(tiny) == 1
    again = train_encoder.main(BASE + ["--iterations", "2", "--root_path", str(tmp_path)])
    assert again["start_iteration"] == 1 and len(tiny) == 2
    fresh = train_encoder.main(BASE + ["--iterations", "1", "--root_path", str(tmp_path / "x")])
    assert tiny[2]["loss"] != tiny[0]["loss"] and fresh["start_iteration"] == 0
