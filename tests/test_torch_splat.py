"""The port's triplane_sample_mean (kernels/splat.py) against the JAX package.

On the CPU the port's plane gradient is the kernel's plain version
(splat3_backward_reference); the JAX op runs its Pallas splat kernel in
interpret mode, as tests/test_splat.py runs it. Both get the same seeded
numpy inputs and the same ray grid and splat blocks (the port's op also
one block shape that does not divide the grid). Tolerances are relative
to the largest |grad|, as there: 5e-5 for f32 tables, 2e-2 for bf16
tables (the JAX op's TPU kernel takes g in bf16, the port's in f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.ops.pallas import splat as jsplat
from nerf_from_image_tpu.ops.triplane import pack_corners, plane_coords, sample_packed
from nerf_from_image_tpu_torch.kernels import splat as tsplat
from tests.test_torch_generator import release_memory  # noqa: F401

B, RES, S = 2, 16, 8
HP, C = 64, 32
N = RES * RES * S
IMG_SHAPE = (RES, RES, S)
BLOCK = (8, 8, 4)


def _smooth_coords(rng, scale=1.05):
    """Ray-coherent points (a linear ramp per ray) with exact +-1 hits."""
    base = rng.uniform(-0.9, 0.9, (B, RES, RES, 1, 3))
    step = rng.uniform(-0.02, 0.02, (B, RES, RES, 1, 3))
    s = np.arange(S).reshape(1, 1, 1, S, 1)
    pts = (base + step * s) * scale
    pts[:, 0, 0, :, 0] = 1.0
    pts[:, 0, 1, :, 1] = -1.0
    return pts.reshape(B, N, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name, seed):
    rng = np.random.default_rng(seed)
    if name == "random":
        coords = rng.uniform(-1.0, 1.0, (B, N, 3)).astype(np.float32)
    else:
        coords = _smooth_coords(rng)
        if name == "misfit":
            # Scattered points in the first blocks: their footprints
            # overflow the JAX kernel's window (its residual-scatter path).
            coords[:, : 8 * 8 * 4] = rng.uniform(-1.0, 1.0, (B, 8 * 8 * 4, 3))
    planes = rng.standard_normal((B, 3, HP, HP, C)).astype(np.float32)
    gw = rng.standard_normal((B, N, C)).astype(np.float32)
    return planes, coords, gw


def _jax_auto(planes, coords3, gw, dt):
    tp = planes.astype(dt) if dt else planes
    packed = pack_corners(tp)
    cs = plane_coords(coords3)
    e = sum(sample_packed(packed[:, k], cs[k]) for k in range(3)) / 3.0
    return jnp.sum(e * gw), e


def _jax_op(planes, coords3, gw, dt):
    e = jsplat.triplane_sample_mean(planes, coords3, IMG_SHAPE, dt, BLOCK, 16, 16)
    return jnp.sum(e * gw), e


@functools.lru_cache(maxsize=None)
def _jitted(fn):
    """One jitted value-and-grad per reference, so that the cases of one
    shape and dtype share its compile."""
    return jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True), static_argnums=3)


def _jax(fn, planes, coords, gw, dt):
    """(samples [B, N, C], d planes, d coords) of sum(samples * gw)."""
    (_, e), (gp, gc) = _jitted(fn)(jnp.asarray(planes), jnp.asarray(coords),
                                   jnp.asarray(gw), dt)
    return np.asarray(e), np.asarray(gp), np.asarray(gc)


@functools.lru_cache(maxsize=None)
def _jax_case(fn, name, dt):
    """_jax of a named case, once per (fn, case, dtype)."""
    return _jax(fn, *_case(name, seed=SEEDS[name]), dt)


def _torch(planes, coords, gw, dt, img_shape=None, block_shape=tsplat.SPLAT_BLOCK):
    p = torch.from_numpy(planes).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    e = tsplat.triplane_sample_mean(p, c, dt, img_shape, block_shape)
    torch.sum(e * torch.from_numpy(gw)).backward()
    return e.detach().numpy(), p.grad.numpy(), c.grad.numpy()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


SEEDS = {"smooth": 0, "misfit": 1, "random": 2}


@pytest.mark.parametrize("name,dt,tol", [
    ("smooth", None, 5e-5),
    ("smooth", "bfloat16", 2e-2),
    ("misfit", None, 5e-5),
    ("random", None, 5e-5),
    ("smooth_ragged_blocks", None, 5e-5),
])
def test_triplane_sample_mean_matches_jax(name, dt, tol):
    """The port's op gets the JAX op's grid and blocks; the ragged case
    gets 5x3x3 blocks, which divide none of the grid's axes."""
    block = BLOCK
    if name == "smooth_ragged_blocks":
        name, block = "smooth", (5, 3, 3)
    planes, coords, gw = _case(name, seed=SEEDS[name])
    et, gpt, gct = _torch(planes, coords, gw, dt, IMG_SHAPE, block)
    for fn in (_jax_op, _jax_auto):
        ej, gpj, gcj = _jax_case(fn, name, dt)
        assert _rel(et, ej) < (1e-6 if dt is None else tol), (fn.__name__, _rel(et, ej))
        assert _rel(gpt, gpj) < tol, (fn.__name__, "planes", _rel(gpt, gpj))
        assert _rel(gct, gcj) < tol, (fn.__name__, "coords", _rel(gct, gcj))


def test_clip_boundary_coordinate_gradient_is_half():
    """At an exact clip boundary (coordinate +-1) the coordinate gradient
    takes jnp.clip's 0.5, not torch.clamp's 1.0."""
    rng = np.random.default_rng(7)
    H = W = 8
    planes = rng.standard_normal((1, 3, H, W, 4)).astype(np.float32)
    coords = np.array([[[1.0, 0.25, -0.5], [-1.0, -0.3, 0.6]]], np.float32)
    gw = np.ones((1, 2, 4), np.float32)
    _, _, gct = _torch(planes, coords, gw, None)
    _, _, gcj = _jax(_jax_auto, planes, coords, gw, None)
    np.testing.assert_allclose(gct, gcj, rtol=1e-5, atol=1e-6)

    # The xy and xz planes carry x; d mean / d x at x = +1, written out:
    # ix = W-1 sits on the base cell W-2 with wx1 = 1, so the x-slope is
    # (r01 - r00) blended over y, times dix/dx = (W-1)/2 and the tie's 0.5.
    def slope(plane, cy, hw):
        iy = (cy + 1.0) * 0.5 * (hw - 1)
        y0 = min(int(np.floor(iy)), hw - 2)
        wy1 = iy - y0
        d = plane[:, W - 1] - plane[:, W - 2]  # [H, C]
        return ((1 - wy1) * d[y0] + wy1 * d[y0 + 1]).sum()

    expected = (slope(planes[0, 0], 0.25, H) + slope(planes[0, 1], -0.5, H))
    expected *= 0.5 * (W - 1) / 3.0 * 0.5
    np.testing.assert_allclose(gct[0, 0, 0], expected, rtol=1e-5)


def test_plane_gradient_reference_counts_no_launch():
    """On CPU tensors the wrapper takes the plain version and counts no
    kernel launch; it checks the ray grid against the points."""
    rng = np.random.default_rng(3)
    coords = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 64, 8)).astype(np.float32))
    before = tsplat.splat3_backward.launches
    out = tsplat.splat3_backward(coords, g, 16, 16)
    assert tsplat.splat3_backward.launches == before
    torch.testing.assert_close(out, tsplat.splat3_backward_reference(coords, g, 16, 16))
    with pytest.raises(TypeError):
        tsplat.splat3_backward(coords.double(), g, 16, 16)
    with pytest.raises(ValueError):
        tsplat.splat3_backward(coords[:, :10], g, 16, 16)
    torch.testing.assert_close(
        tsplat.splat3_backward(coords, g, 16, 16, (2, 4, 8), (3, 3, 3)), out)
    assert tsplat.splat3_backward.launches == before
    for img_shape, block in (((2, 4, 7), (1, 1, 1)), ((2, 4, 8), (16, 16, 8)),
                             ((2, 4, 8), (0, 1, 1)), ((64,), (1, 1, 1))):
        with pytest.raises(ValueError):
            tsplat.splat3_backward(coords, g, 16, 16, img_shape, block)
    with pytest.raises(ValueError, match="CUDA"):
        tsplat.splat3_backward(coords, g, 16, 16, stats=torch.zeros(3, dtype=torch.int64))
