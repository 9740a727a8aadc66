"""The view-direction branch (CARLA) of the port against the JAX package.

A tiny use_viewdir generator (tests/test_torch_generator.py's config):
its per-ray embedding, and a render's values and (ws, pose) gradients of
the loss sum(rgb^2) + sum(mask^2) at 16^2 rays, 8 + 8 samples, unchunked
and chunked (the embedding is expanded per point and chunks with the
points): the embedding, the rendered values and the gradients within
rtol 1e-4 and atol 1e-6 of JAX, elementwise. The gradients are also held
to the port's render in float64: each package's f32 gradient is within
that tolerance of it, so where the two f32 gradients differ most, they
are rounding on either side of one value. Every weight is drawn from a seed
(tests/test_torch_generator.py::seeded_generator_variables): the branch's
output projection is zero-initialized, and with zeros the embedding would
not reach the colour.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.engine import render as jrender
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu_torch.engine import render as trender
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_generator import (  # noqa: F401
    TINY,
    jax_compiled,
    release_memory,
    seeded_generator_variables,
)
from tests.test_torch_render import SR_INNER, _camera, _rel

RTOL, ATOL = 1e-4, 1e-6
CFG = dict(resolution=16, depth_samples_per_ray=8, fine_sampling=True, scene_range=SR_INNER,
           use_viewdir=True)


@functools.lru_cache(maxsize=1)
def _viewdir_pair():
    """(JAX model, its variables, the port's model with the same weights),
    every weight from a seed (the view-direction output projection too)."""
    jm = JaxGenerator(**TINY, use_viewdir=True)
    variables = seeded_generator_variables(jm, 11)
    tm = Generator(**TINY, use_viewdir=True, device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


def _ws():
    jm = _viewdir_pair()[0]
    return (np.random.default_rng(2).standard_normal((1, jm.num_ws, 64)) * 0.1).astype(np.float32)


def test_viewdir_embedding_and_names_match_jax():
    jm, variables, tm = _viewdir_pair()
    assert "viewdir_mapper.output.weight" in tm.state_dict()
    assert tm.decoder.net[2].out_features == 1 + 32
    dirs = np.random.default_rng(3).standard_normal((2, 6, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jm.apply(variables, jnp.asarray(dirs), method="viewdir_embedding")
    with torch.no_grad():
        got = tm.viewdir_embedding(torch.from_numpy(dirs))
    assert got.shape == (2, 6, 1, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    features = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="viewdir embedding"):
        tm.color_from_features(features, torch.zeros(1, 4, 3))


@functools.lru_cache(maxsize=None)
def _jax_render(no_cam_grad):
    """The JAX render's (rgb, mask, d ws, d pose) as numpy."""
    jm, variables, _ = _viewdir_pair()
    pose, focal = _camera()
    jcfg = jrender.RenderConfig(query_chunk=None, **CFG)

    def jloss(ws, pose):
        out, _ = jrender.render(jcfg, jm, variables, pose, jnp.asarray(focal), ws,
                                force_no_cam_grad=no_cam_grad)
        return jnp.sum(jnp.square(out.rgb)) + jnp.sum(jnp.square(out.mask)), out

    args = (jnp.asarray(_ws()), jnp.asarray(pose))
    (_, jout), (jgw, jgp) = jax_compiled(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True), *args)(*args)
    return tuple(np.asarray(t) for t in (jout.rgb, jout.mask, jgw, jgp))


@pytest.mark.parametrize("splat,chunk,no_cam_grad", [
    (False, None, False),
    (True, None, False),
    (True, 600, False),  # chunked, padded to whole chunks
    (True, None, True),
])
def test_viewdir_render_values_and_gradients_match_jax(splat, chunk, no_cam_grad):
    """With force_no_cam_grad the view directions are detached with the
    coarse points and depths: the pose's gradient is then only the fine
    points' (through the ray origins), in both packages."""
    _, _, tm = _viewdir_pair()
    pose, focal = _camera()
    jrgb, jmask, jgw, jgp = _jax_render(no_cam_grad)
    tcfg = trender.RenderConfig(query_chunk=chunk, plane_splat=splat, **CFG)
    tws = torch.from_numpy(_ws()).requires_grad_(True)
    tpose = torch.from_numpy(pose).requires_grad_(True)
    tout, _ = trender.render(tcfg, tm, tpose, torch.from_numpy(focal), tws,
                             force_no_cam_grad=no_cam_grad, device="cpu")
    (torch.sum(tout.rgb ** 2) + torch.sum(tout.mask ** 2)).backward()
    np.testing.assert_allclose(tout.rgb.detach().numpy(), jrgb, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout.mask.detach().numpy(), jmask, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tws.grad.numpy(), jgw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tpose.grad.numpy(), jgp, rtol=RTOL, atol=ATOL)
    if no_cam_grad:
        assert not tpose.grad[:, :, :3].any()


def test_viewdir_gradients_round_around_a_float64_render():
    """The chunked case's (ws, pose) gradients: JAX's and the port's f32
    gradients each within rtol 1e-4 and atol 1e-6 of the port's render
    with every weight and input in float64."""
    _, _, tm = _viewdir_pair()
    pose, focal = _camera()
    _, _, jgw, jgp = _jax_render(False)
    tcfg = trender.RenderConfig(query_chunk=600, plane_splat=True, **CFG)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(tm).to(dtype)
        tws = torch.from_numpy(_ws()).to(dtype).requires_grad_(True)
        tpose = torch.from_numpy(pose).to(dtype).requires_grad_(True)
        tout, _ = trender.render(tcfg, model, tpose, torch.from_numpy(focal).to(dtype), tws,
                                 device="cpu")
        (torch.sum(tout.rgb ** 2) + torch.sum(tout.mask ** 2)).backward()
        grads[dtype] = (tws.grad.numpy(), tpose.grad.numpy())
    for got in (grads[torch.float32], (jgw, jgp)):
        for g, want in zip(got, grads[torch.float64]):
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)
