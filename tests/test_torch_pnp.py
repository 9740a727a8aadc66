"""The port's batched PnP and pose helpers against the JAX package.

Every case feeds both packages the same numpy coordinate maps (from
tests/test_pnp.py's synth_problem) in f32: poses within 1e-4 absolute,
focals equal, and the foreground compaction selecting the same rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.pose import pnp as jpnp
from nerf_from_image_tpu.pose import pose as jpose
from nerf_from_image_tpu_torch.pose import pnp as tpnp
from nerf_from_image_tpu_torch.pose import pose as tpose
from tests.test_pnp import synth_problem
from tests.test_torch_generator import release_memory  # noqa: F401

POSE_TOL = 1e-4
GUESSES = np.array([0.9, 1.3, 2.0])


@functools.lru_cache(maxsize=None)
def _jax_pnp(max_points):
    return jax.jit(functools.partial(jpnp.compute_pose_pnp, max_points=max_points))


@functools.lru_cache(maxsize=None)
def _jax_estimate(ortho):
    if ortho:
        return jax.jit(lambda c, m, _: jpnp.estimate_poses_batch(c, m, None))
    return jax.jit(jpnp.estimate_poses_batch)


def _problem(seed, B=2, H=24, W=24, noise=0.0):
    coords, masks, w2c, focal = synth_problem(np.random.default_rng(seed), B=B, H=H, W=W,
                                              noise=noise)
    return coords, masks, w2c, focal


def _assert_pnp_equal(port, ref):
    w2c, f, err = (t.numpy() for t in port)
    jw2c, jf, jerr = (np.asarray(t) for t in ref)
    np.testing.assert_allclose(w2c, jw2c, rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(err, jerr, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("case", ["exact", "noisy", "truncated", "dummy"])
def test_compute_pose_pnp_matches_jax(case):
    """Perspective PnP over 3 focal guesses: exact and noisy maps, a
    budget under the foreground count (the truncated compaction), and a
    sample with fewer than 4 points next to a good one (the dummy pose)."""
    coords, masks, w2c_gt, focal = _problem(11, noise=0.002 if case == "noisy" else 0.0)
    max_points = 8192
    if case == "truncated":
        max_points = int(masks.sum(axis=(1, 2)).min()) // 2
    if case == "dummy":
        masks[1] = False
        masks[1, 0, :3] = True
    port = tpnp.compute_pose_pnp(torch.from_numpy(coords), torch.from_numpy(masks), GUESSES,
                                 max_points=max_points)
    ref = _jax_pnp(max_points)(jnp.asarray(coords), jnp.asarray(masks), jnp.asarray(GUESSES))
    _assert_pnp_equal(port, ref)
    if case == "exact":
        np.testing.assert_allclose(port[0].numpy(), w2c_gt, atol=2e-3)
        np.testing.assert_allclose(port[1].numpy(), focal)
    if case == "dummy":
        dummy = np.diag([1.0, -1.0, -1.0, 1.0])
        dummy[2, 3] = 10.0  # diag(1, -1, -1) @ (0, 0, -10)
        np.testing.assert_array_equal(port[0][1].numpy(), dummy)
        assert float(port[1][1]) == 1.0 and float(port[2][1]) == 10.0


def test_non_finite_coordinates_give_the_dummy_pose():
    """An infinite coordinate in one sample's foreground: JAX lets the NaN
    of its eigenproblem and Gauss-Newton solves reach the isfinite guard,
    and so does the port (its eigh and solve raise nothing); that sample
    gets the dummy pose, the other its own."""
    coords, masks, _, _ = _problem(11)
    ys, xs = np.nonzero(masks[1])
    coords[1, ys[0], xs[0], 0] = np.inf
    port = tpnp.compute_pose_pnp(torch.from_numpy(coords), torch.from_numpy(masks), GUESSES)
    ref = _jax_pnp(8192)(jnp.asarray(coords), jnp.asarray(masks), jnp.asarray(GUESSES))
    _assert_pnp_equal(port, ref)
    assert float(port[2][1]) == 10.0 and float(port[2][0]) < 1e-3


def _ortho_problem(rng, B=2, H=24, W=24, focal=100.0, dist=150.0):
    """A coordinate map seen by a far camera with focal 100, the
    approximation that estimate_poses_batch makes for orthographic
    datasets: each pixel's point on its ray, depths dist +- 40."""
    coords = np.zeros((B, H, W, 3), np.float32)
    jj, ii = np.meshgrid(np.arange(H) / H - 0.5, np.arange(W) / W - 0.5, indexing="ij")
    for b in range(B):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        t = np.array([0.1, -0.05, dist])
        z = dist + rng.uniform(-40.0, 40.0, (H, W))
        coords[b] = (np.stack((ii / focal * z, jj / focal * z, z), -1) - t) @ q
    masks = np.broadcast_to(ii**2 + jj**2 < 0.16, (B, H, W))
    return coords, np.ascontiguousarray(masks)


@pytest.mark.parametrize("ortho", [False, True])
def test_estimate_poses_batch_matches_jax(ortho):
    """Encoder-style soft masks (thresholded at 0.9): perspective with the
    train-focal percentiles, orthographic with focal_guesses None.

    The orthographic path solves at focal 100, where the normalized
    screen coordinates are ~1/100 of the point coordinates: in f32 the
    DLT's eigenvector and so the camera depth come out ~1% apart in the
    two packages (each ~1% from the truth), and the depth sets the
    orthographic scale: the whole matrix scales with it (1.5% apart here).
    The rotation (the 3x3 block over the scale entry) is held to 1e-4
    absolute, the translation over the scale entry to 3e-3 relative per
    entry (0.09% apart), and the scale entry to 3e-2 relative."""
    if ortho:
        coords, masks = _ortho_problem(np.random.default_rng(2))
    else:
        coords, masks, _, _ = _problem(2)
    soft = np.where(masks, 0.95, 0.5).astype(np.float32)
    train_focals = None if ortho else np.linspace(1.0, 1.6, 7)
    guesses = tpnp.get_focal_guesses(train_focals)
    want = jpnp.get_focal_guesses(train_focals)
    assert (guesses is None) == ortho == (want is None)
    if not ortho:
        np.testing.assert_array_equal(guesses, want)
    cam, f, err = tpnp.estimate_poses_batch(torch.from_numpy(coords), torch.from_numpy(soft),
                                            guesses)
    jcam, jf, jerr = _jax_estimate(ortho)(jnp.asarray(coords), jnp.asarray(soft),
                                         None if ortho else jnp.asarray(guesses))
    cam, jcam = cam.numpy(), np.asarray(jcam)
    if ortho:
        assert f is None and jf is None
        rot, jrot = (m[:, :3, :3] / m[:, 3:, 3:] for m in (cam, jcam))
        np.testing.assert_allclose(rot, jrot, rtol=0, atol=POSE_TOL)
        t, jt = (m[:, :3, 3] / m[:, 3:, 3] for m in (cam, jcam))
        np.testing.assert_allclose(t, jt, rtol=3e-3, atol=0)
        np.testing.assert_allclose(cam[:, 3, 3], jcam[:, 3, 3], rtol=3e-2, atol=0)
        np.testing.assert_array_equal(cam[:, 3, :3], 0.0)
    else:
        np.testing.assert_allclose(cam, jcam, rtol=0, atol=POSE_TOL)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-3, atol=1e-5)


def test_compute_pose_pnp_known_k_matches_jax():
    coords, masks, _, focal = _problem(5)
    soft = masks.astype(np.float32)
    K = np.tile(np.array([[focal, 0.0, 0.0], [0.0, focal, 0.0], [0.0, 0.0, 1.0]],
                         np.float32), (2, 1, 1))
    K[1, 0, 2], K[1, 1, 1] = 0.01, focal * 1.05  # off-centre, anisotropic
    cam, err = tpnp.compute_pose_pnp_known_k(torch.from_numpy(coords),
                                             torch.from_numpy(soft), torch.from_numpy(K))
    jcam, jerr = jax.jit(jpnp.compute_pose_pnp_known_k)(jnp.asarray(coords),
                                                        jnp.asarray(soft), jnp.asarray(K))
    np.testing.assert_allclose(cam.numpy(), np.asarray(jcam), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("budget", [256, 1000])
def test_compaction_of_an_oversized_mask_selects_the_same_rows(budget):
    """More foreground than the budget: torch.topk's tie order would
    differ; the port's stable sort keeps JAX top_k's ascending index order
    among the equal 0/1 weights, so the same rows survive, in the same
    order (a 32x32 map: the bit-reversal order is a power-of-two
    permutation; 1000 rows of a 40x25 map: the argsort branch)."""
    H, W = (32, 32) if budget == 256 else (40, 25)
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((2, H * W, 3)).astype(np.float32)
    uv = rng.uniform(-0.5, 0.5, (2, H * W, 2)).astype(np.float32)
    w = (rng.random((2, H * W)) > 0.2).astype(np.float32)
    w[1] = 1.0  # full-frame foreground
    for n in (H * W, 7):
        np.testing.assert_array_equal(tpnp._bit_reversal_permutation(n),
                                      jpnp._bit_reversal_permutation(n))
    port = tpnp._compact_foreground(*(torch.from_numpy(a) for a in (pts, uv, w)), budget)
    ref = jpnp._compact_foreground(*(jnp.asarray(a) for a in (pts, uv, w)), budget)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The kept rows of the full mask span the image (tests/test_pnp.py's check).
    kept_v = port[1][1][:, 1].numpy()
    assert 0.35 < float(np.mean(kept_v > 0)) < 0.65


def test_rodrigues_and_polar_orthogonalize_match_jax():
    rng = np.random.default_rng(4)
    rvec = rng.standard_normal((5, 3)).astype(np.float32)
    rvec[0] = 0.0
    a = (rng.standard_normal((4, 3, 3)) + 2 * np.eye(3)).astype(np.float32)
    jrot, jpolar = jax.jit(lambda r, a: (jpnp.rodrigues(r), jpnp.polar_orthogonalize(a)))(
        jnp.asarray(rvec), jnp.asarray(a))
    np.testing.assert_allclose(tpnp.rodrigues(torch.from_numpy(rvec)).numpy(),
                               np.asarray(jrot), atol=1e-6)
    got = tpnp.polar_orthogonalize(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpolar), atol=1e-5)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.tile(np.eye(3), (4, 1, 1)),
                               atol=1e-5)


def _rotations(rng, n):
    mats = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        m = np.eye(4)
        m[:3, :3] = q
        m[:3, 3] = q @ np.array([0.0, 0.0, 2.5])
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def test_pose_helpers_match_jax():
    """rotation_matrix_distance (4x4 with a scale entry, 3x3, and an
    identical pair that clips the cosine), matrix_to_conditioning_vector
    (perspective, orthographic, flipped), perturb_poses (numpy's seeded
    targets and explicit ones)."""
    rng = np.random.default_rng(6)
    p, q = _rotations(rng, 6), _rotations(rng, 6)
    p[2, 3, 3] = 1.7
    q[2] = p[2]
    for a, b in ((p, q), (p[:, :3, :3], q[:, :3, :3])):
        got = tpose.rotation_matrix_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(jpose.rotation_matrix_distance(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, atol=1e-3)
        assert np.all(np.isfinite(got))
    focal = rng.uniform(1.0, 2.0, 6).astype(np.float32)
    for f, flipped in ((focal, False), (None, False), (focal, True)):
        got = tpose.matrix_to_conditioning_vector(
            torch.from_numpy(p), None if f is None else torch.from_numpy(f), flipped)
        want = jpose.matrix_to_conditioning_vector(
            jnp.asarray(p), None if f is None else jnp.asarray(f), flipped)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    extra = np.arange(6)
    for targets in (None, np.array([0.0, 30.0, 60.0, 90.0, 120.0, 150.0])):
        got = tpose.perturb_poses(p, 40.0, extra, None, seed=7, target_distances=targets)
        want = jpose.perturb_poses(p, 40.0, extra, None, seed=7, target_distances=targets)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] is None and want[2] is None
