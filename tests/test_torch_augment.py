"""The port's grid samples (ops/grid_sample.py) and crop augmentation
(engine/augment.py) against the JAX package, at 1e-5 of the largest value.

The two packages cannot draw the same random transform, so a fixed
transform made from seeded numpy is fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.engine import augment as jaug
from nerf_from_image_tpu.ops import grid_sample as jgs
from nerf_from_image_tpu_torch.engine import augment as taug
from nerf_from_image_tpu_torch.ops import grid_sample as tgs
from tests.test_torch_generator import release_memory  # noqa: F401

TOL = 1e-5


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _transform(B, seed=0):
    rng = np.random.default_rng(seed)
    rot = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    scale = np.exp2(rng.standard_normal(B) * 0.2).astype(np.float32)
    translation = (rng.standard_normal((B, 2)) * 0.1).astype(np.float32)
    return (jaug.AugmentTransform(*map(jnp.asarray, (rot, scale, translation))),
            taug.AugmentTransform(*map(torch.from_numpy, (rot, scale, translation))))


@pytest.mark.parametrize("name", ["grid_sample_2d", "grid_sample_2d_zeros",
                                  "grid_sample_2d_zeros_packed"])
def test_grid_samples_values_and_gradients(name):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 300, 2)).astype(np.float32)
    coords[:, :4] = [[-1.0, -1.0], [1.0, 1.0], [1.0, -0.2], [0.3, -1.0]]  # on the edges
    cot = rng.standard_normal((2, 300, 5)).astype(np.float32)
    jfn = getattr(jgs, name)
    (_, jv), (jgt, jgc) = jax.jit(jax.value_and_grad(
        lambda t, c: (jnp.sum(jfn(t, c) * cot), jfn(t, c)), argnums=(0, 1), has_aux=True))(
        jnp.asarray(table), jnp.asarray(coords))
    tt = torch.from_numpy(table).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    tv = getattr(tgs, name)(tt, tc)
    torch.sum(tv * torch.from_numpy(cot)).backward()
    assert _rel(tv, jv) < TOL
    assert _rel(tt.grad, jgt) < TOL
    assert _rel(tc.grad, jgc) < TOL


@pytest.mark.parametrize("white_background", [False, True])
def test_augment_image_matches_jax(white_background):
    rng = np.random.default_rng(2)
    img = rng.uniform(-1.0, 1.0, (3, 12, 10, 6)).astype(np.float32)
    jt, tt = _transform(3)
    want = jax.jit(jaug.augment_image, static_argnums=2)(jnp.asarray(img), jt, white_background)
    timg = torch.from_numpy(img).requires_grad_(True)
    got = taug.augment_image(timg, tt, white_background)
    assert _rel(got, want) < TOL
    cot = rng.standard_normal(img.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(jaug.augment_image(x, jt, white_background) * cot)))(
        jnp.asarray(img))
    torch.sum(got * torch.from_numpy(cot)).backward()
    assert _rel(timg.grad, jg) < TOL


@pytest.mark.parametrize("perspective", [True, False])
def test_augment_pose_matches_jax(perspective):
    rng = np.random.default_rng(3)
    B = 3
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    pose[:, :3, :3] = q
    pose[:, :3, 3] = rng.standard_normal((B, 3)) * 2.0
    if not perspective:
        pose[:, 3, 3] = rng.uniform(0.5, 2.0, B)  # inverse ortho scale
    focal = rng.uniform(1.0, 2.0, B).astype(np.float32) if perspective else None
    jt, tt = _transform(B, seed=4)
    jp, jf = jax.jit(jaug.augment_pose)(
        jnp.asarray(pose), None if focal is None else jnp.asarray(focal), jt)
    tp, tf = taug.augment_pose(torch.from_numpy(pose),
                               None if focal is None else torch.from_numpy(focal), tt)
    assert _rel(tp, jp) < TOL
    if perspective:
        assert _rel(tf, jf) < TOL
    else:
        assert tf is None and jf is None
    # Image and camera together, through augment() with a given transform.
    img = rng.uniform(-1.0, 1.0, (B, 8, 8, 3)).astype(np.float32)
    out = taug.augment(None, torch.from_numpy(img), torch.from_numpy(pose),
                       None if focal is None else torch.from_numpy(focal), 1.0,
                       white_background=True, tform=tt)
    jout = jax.jit(lambda i, p, f: jaug.augment(None, i, p, f, jnp.asarray(1.0),
                                                white_background=True, tform=jt))(
        jnp.asarray(img), jnp.asarray(pose), None if focal is None else jnp.asarray(focal))
    assert _rel(out[0], jout[0]) < TOL and _rel(out[1], jout[1]) < TOL


def test_sample_transform_draws_from_the_generator():
    a = taug.sample_transform(torch.Generator().manual_seed(5), 64, 1.0)
    b = taug.sample_transform(torch.Generator().manual_seed(5), 64, 1.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.rot.shape == (64,) and a.scale.shape == (64,) and a.translation.shape == (64, 2)
    assert float(a.rot.abs().max()) <= np.pi and float(a.rot.abs().min()) > 0
    off = taug.sample_transform(torch.Generator().manual_seed(5), 64, 0.0)
    assert torch.all(off.rot == 0) and torch.all(off.scale == 1) and torch.all(off.translation == 0)
    fixed = taug.sample_transform(torch.Generator().manual_seed(5), 64, 1.0, disable_scale=True)
    assert torch.all(fixed.scale == 1) and torch.equal(fixed.translation, a.translation)
    # The identity transform leaves an image unchanged.
    img = torch.rand((2, 6, 6, 3))
    ident = taug.sample_transform(None, 2, 0.0)
    assert torch.allclose(taug.augment_image(img, ident, False), img, atol=1e-6)
