"""The port's render and inversion against the JAX package at a tiny config.

Values and (ws, pose) gradients of the bench loss sum(rgb^2) + sum(mask^2)
at 16^2 rays, 8 + 8 samples. The box is pulled 1e-4 inside the
generator's (tests/test_splat.py's _SR_INNER) so that no sample sits on
the clip kink of the plane coordinates; tolerance 1e-4 of the largest
|grad| there. The inversion is held against a JAX loop composed here from
render(key=None), reconstruction_loss, optax.adam and inversion._project,
since the two frameworks' random streams cannot match; the 'vgg' loop gets
the crop-augmentation transforms the port drew, step by step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_from_image_tpu.engine import augment as jaug
from nerf_from_image_tpu.engine import inversion as jinv
from nerf_from_image_tpu.engine import render as jrender
from nerf_from_image_tpu_torch.engine import augment as taug
from nerf_from_image_tpu_torch.engine import inversion as tinv
from nerf_from_image_tpu_torch.engine import render as trender
from nerf_from_image_tpu_torch.kernels import splat as tsplat
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from tests.test_torch_generator import (  # noqa: F401
    jax_compiled,
    lpips_pair,
    release_memory,
    tiny_pair,
)

SR_INNER = 1.4 * (1.0 - 1e-4)
TOL_INNER = 1e-4


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _camera():
    pose = np.eye(4, dtype=np.float32)[None]
    pose[:, 2, 3] = 2.5
    return pose, np.full((1,), 1.2, np.float32)


def _ws():
    return (np.random.default_rng(1).standard_normal((1, tiny_pair()[0].num_ws, 64))
            * 0.1).astype(np.float32)


def _common(merge, zbuffer):
    return dict(resolution=16, depth_samples_per_ray=8, fine_sampling=True,
                scene_range=SR_INNER, merge_mode=merge, zbuffer_depth=zbuffer)


@functools.lru_cache(maxsize=None)
def _jax_render(merge, zbuffer):
    """The JAX render's (rgb, mask, depth, d ws, d pose) as numpy, once per
    JAX config: the splat and chunk cases share the unchunked autodiff
    reference path."""
    jm, variables, _ = tiny_pair()
    pose, focal = _camera()
    jcfg = jrender.RenderConfig(query_chunk=None, **_common(merge, zbuffer))

    def jloss(ws, pose):
        out, _ = jrender.render(jcfg, jm, variables, pose, jnp.asarray(focal), ws)
        return jnp.sum(jnp.square(out.rgb)) + jnp.sum(jnp.square(out.mask)), out

    args = (jnp.asarray(_ws()), jnp.asarray(pose))
    (_, jout), (jgw, jgp) = jax_compiled(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True), *args)(*args)
    return tuple(np.asarray(t) for t in (jout.rgb, jout.mask, jout.depth, jgw, jgp))


@pytest.mark.parametrize("splat,merge,chunk,zbuffer", [
    (False, "pairwise", None, False),
    (True, "pairwise", None, False),
    (True, "sort", None, True),
    (True, "pairwise", 600, False),  # chunked, padded to whole chunks
    (True, "pairwise", 512, False),  # chunked, each chunk 4 whole image rows
])
def test_render_values_and_gradients_match_jax(splat, merge, chunk, zbuffer, monkeypatch):
    """Also checks the ray grid each splat backward is handed: the whole
    16x16x8 grid unchunked, a 4x16x8 grid per chunk of whole rows, none
    for a padded chunk."""
    _, _, tm = tiny_pair()
    pose, focal = _camera()
    ws = _ws()
    tcfg = trender.RenderConfig(query_chunk=chunk, plane_splat=splat, **_common(merge, zbuffer))
    jrgb, jmask, jdepth, jgw, jgp = _jax_render(merge, zbuffer)
    grids = []
    splat_backward = tsplat.splat3_backward

    def record(coords3, g, H, W, img_shape, block_shape):
        grids.append((img_shape, block_shape))
        return splat_backward(coords3, g, H, W, img_shape, block_shape)

    monkeypatch.setattr(tsplat, "splat3_backward", record)
    tws = torch.from_numpy(ws).requires_grad_(True)
    tpose = torch.from_numpy(pose).requires_grad_(True)
    tout, _ = trender.render(tcfg, tm, tpose, torch.from_numpy(focal), tws, device="cpu")
    (torch.sum(tout.rgb ** 2) + torch.sum(tout.mask ** 2)).backward()
    for name, want in (("rgb", jrgb), ("mask", jmask), ("depth", jdepth)):
        assert _rel(getattr(tout, name), want) < 1e-5, name
    assert _rel(tws.grad, jgw) < TOL_INNER
    assert _rel(tpose.grad, jgp) < TOL_INNER
    # One call per pass (coarse, fine) and chunk: 2048 points a pass.
    img_shape, n_calls = {None: ((16, 16, 8), 2), 600: (None, 8), 512: ((4, 16, 8), 8)}[chunk]
    assert grids == [(img_shape, tcfg.splat_block)] * (n_calls if splat else 0)


RC_KW = dict(resolution=16, depth_samples_per_ray=8, scene_range=SR_INNER, query_chunk=None)


@functools.lru_cache(maxsize=1)
def _inversion_start():
    """(target rgb, z0, JAX pose params) of the tiny inversion, shared by
    its tests: the target is the JAX render at a seeded w."""
    jm, variables, _ = tiny_pair()
    pose, focal = _camera()
    rng = np.random.default_rng(2)
    jrc = jrender.RenderConfig(**RC_KW)
    w_true = (rng.standard_normal((1, 1, 64)) * 0.5).astype(np.float32)
    args = (jnp.asarray(pose), jnp.asarray(focal), jnp.asarray(w_true))
    target = jax_compiled(lambda p, f, w: jrender.render(jrc, jm, variables, p, f, w)[0].rgb,
                          *args)(*args)
    target = np.asarray(target)
    z0 = (rng.standard_normal((1, 1, 64)) * 0.1
          / jinv.InversionConfig.lr_gain_z).astype(np.float32)
    p0 = jinv.pose_params_from_matrix(jnp.asarray(pose), jnp.asarray(focal), False)
    p0 = p0._replace(q=p0.q + jnp.asarray([[0.0, 0.03, -0.02, 0.01]]),
                     t2=p0.t2 + jnp.asarray([[0.02, -0.01]]))
    return target, z0, p0


def _inversion_case(loss, steps, num_augmentations=15):
    """(JAX config, render config, target, z0, JAX pose params, port
    inversion config, port render config) of the tiny inversion."""
    cfg_kw = dict(steps=steps, loss=loss, num_augmentations=num_augmentations)
    target, z0, p0 = _inversion_start()
    return (jinv.InversionConfig(**cfg_kw), jrender.RenderConfig(**RC_KW), target, z0, p0,
            tinv.InversionConfig(**cfg_kw), trender.RenderConfig(plane_splat=True, **RC_KW))


def _jax_inversion(jcfg, jrc, target, z0, p0, lpips_model=None, lpips_vars=None,
                   tforms=None, monkeypatch=None):
    """The JAX inversion loop composed from its parts, one jitted step;
    returns (z, pose params, losses). `tforms` are the crop-augmentation
    transforms of the steps, handed to JAX's augment in place of its draws."""
    jm, variables, _ = tiny_pair()
    features = None
    if lpips_model is not None:
        features = jax.jit(lambda v, t: lpips_model.apply(v, t, method="features"))(
            lpips_vars, jnp.asarray(target))
    step_tform = []
    if tforms is not None:
        monkeypatch.setattr(jaug, "sample_transform", lambda *a, **k: step_tform[0])

    def loss_fn(opt, tform):
        step_tform[:] = [tform]
        cam, f = jinv.build_camera(opt["pose"], False)
        out, _ = jrender.render(jrc, jm, variables, cam, f, opt["z"] * jcfg.lr_gain_z)
        return jinv.reconstruction_loss(jcfg, lpips_model, lpips_vars, out.rgb[..., :3],
                                        jnp.asarray(target), features, None)

    opt = {"z": jnp.asarray(z0), "pose": p0}
    tx = optax.adam(jcfg.lr, b1=jcfg.b1, b2=jcfg.b2)
    state = tx.init(opt)
    losses = []
    # The 'vgg' loop runs VGG16, which runs slowly at -O0.
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    for k in range(jcfg.steps):
        args = (opt, None if tforms is None else tforms[k])
        if lpips_model is None and k == 0:
            value_and_grad = jax_compiled(jax.value_and_grad(loss_fn), *args)
        loss, grads = value_and_grad(*args)
        updates, state = tx.update(grads, state, opt)
        opt = optax.apply_updates(opt, updates)
        opt = {"z": opt["z"], "pose": jinv._project(opt["pose"])}
        losses.append(float(loss))
    return opt["z"], opt["pose"], losses


def _assert_same_inversion(port, jax_result):
    z, p, losses = port
    jz, jp, jlosses = jax_result
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-4)
    assert jlosses[-1] < jlosses[0]
    assert _rel(z, jz) < 1e-4
    for a, b in zip(p, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_mse_inversion_matches_jax_loop():
    jcfg, jrc, target, z0, p0, tcfg, trc = _inversion_case("mse", 3)
    invert = tinv.make_invert_fn(tcfg, trc, tiny_pair()[2], device="cpu")
    tp0 = tinv.PoseParams(*(torch.from_numpy(np.asarray(x)) for x in p0))
    port = invert(torch.from_numpy(z0), tp0, torch.from_numpy(target))
    _assert_same_inversion(port, _jax_inversion(jcfg, jrc, target, z0, p0))


def test_vgg_inversion_matches_jax_loop(monkeypatch):
    """Two 'vgg' steps with 2 crop augmentations: the port draws each
    step's transform from its generator, the JAX loop is handed the same
    transforms in the same order."""
    jcfg, jrc, target, z0, p0, tcfg, trc = _inversion_case("vgg", 2, num_augmentations=2)
    jl, lpips_vars, tl = lpips_pair()
    drawn = []

    def record(*args, **kwargs):
        drawn.append(sample(*args, **kwargs))
        return drawn[-1]

    sample = taug.sample_transform
    monkeypatch.setattr(taug, "sample_transform", record)
    invert = tinv.make_invert_fn(tcfg, trc, tiny_pair()[2], lpips=tl, device="cpu")
    tp0 = tinv.PoseParams(*(torch.from_numpy(np.asarray(x)) for x in p0))
    port = invert(torch.from_numpy(z0), tp0, torch.from_numpy(target))
    assert len(drawn) == 2 and drawn[0].rot.shape == (2,)
    assert not torch.equal(drawn[0].rot, drawn[1].rot)

    tforms = [jaug.AugmentTransform(*(jnp.asarray(t.numpy()) for t in tf)) for tf in drawn]
    _assert_same_inversion(port, _jax_inversion(jcfg, jrc, target, z0, p0, jl, lpips_vars,
                                                tforms, monkeypatch))


def test_inversion_keeps_focal_and_rejects_perceptual_losses():
    """The focal stays fixed under the default 'vgg' loss; a perceptual
    loss without an LPIPS module, or an unknown loss, is rejected."""
    _, _, tm = tiny_pair()
    pose, focal = _camera()
    # 16^2 images: the smallest that the four 2x2 pools of VGG16 take.
    rc = trender.RenderConfig(resolution=16, depth_samples_per_ray=4, scene_range=SR_INNER,
                              query_chunk=None, plane_splat=True)
    for loss in ("vgg", "vgg_nocrop", "mixed"):
        with pytest.raises(ValueError, match="LPIPS"):
            tinv.make_invert_fn(tinv.InversionConfig(loss=loss), rc, tm, device="cpu")
    with pytest.raises(ValueError):
        tinv.make_invert_fn(tinv.InversionConfig(loss="ssim"), rc, tm, device="cpu")
    cfg = tinv.InversionConfig(steps=2, optimize_focal=False, num_augmentations=1)
    assert cfg.loss == "vgg"
    p0 = tinv.pose_params_from_matrix(torch.from_numpy(pose), torch.from_numpy(focal), False)
    target = torch.zeros((1, 16, 16, 3))
    z0 = torch.zeros((1, 1, 64))
    lpips = LPIPS(torch.Generator().manual_seed(0), device="cpu")
    _, p, losses = tinv.make_invert_fn(cfg, rc, tm, lpips=lpips, device="cpu")(z0, p0, target)
    assert torch.equal(p.z0, p0.z0)
    assert not torch.equal(p.t2, p0.t2)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
