"""The training-time evaluation (engine/gan_eval.py) on the port against the
JAX package, at tests/test_gan_engine.py::tiny_models' sizes, in f32.

tests/test_torch_gan.py's tiny generators (unconditional, and
encoder-conditional for the reconstruction modes), an LPIPS of seeded
random features, and a stand-in for Inception (a per-pixel linear map,
tanh, the mean over H and W: 4 features, so that 6 renders give full-rank
statistics) in both packages. evaluate_recon in its three modes (the
generation FID is its mode None) and compute_real_fid_stats (with its 2x
average pool): statistics, means, FIDs and the first batch's maps within
1e-4 (relative; maps relative to their largest value). The JAX FIDs are f32, the port's float64
(metrics/fid.py::FID_DTYPE); on full-rank statistics both converge.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.data.splits import DatasetSplit as JaxSplit
from nerf_from_image_tpu.engine import gan_eval as jeval
from nerf_from_image_tpu.engine import render as jrender
from nerf_from_image_tpu_torch.data.splits import DatasetSplit, compute_view_perm
from nerf_from_image_tpu_torch.engine import gan_eval as teval
from nerf_from_image_tpu_torch.engine.render import RenderConfig
from tests.test_torch_gan import SR_INNER, gen_pair
from tests.test_torch_generator import release_memory  # noqa: F401
from tests.test_torch_hybrid import _lpips_pair

TOL = 1e-4
RES, N, BS, FEATURES = 16, 6, 3, 4
RC_KW = dict(resolution=RES, depth_samples_per_ray=8, scene_range=SR_INNER, query_chunk=None)


class JaxStandIn:
    """Inception's place in the JAX package: .apply(variables, x [B, H, W,
    3] in [0, 1]) -> [B, FEATURES]."""

    def apply(self, variables, x):
        return jnp.mean(jnp.tanh(x @ variables["w"]), axis=(1, 2))


class StandIn(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.from_numpy(w)

    def forward(self, x):
        return torch.mean(torch.tanh(x @ self.w), dim=(1, 2))


STAND_IN_W = np.random.default_rng(2).standard_normal((3, FEATURES)).astype(np.float32) * 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


@functools.lru_cache(maxsize=1)
def _data():
    """(eval images [N, 16, 16, 4], cameras, real images [8, 32, 32, 4],
    z_fid, encoder inputs [N, 16, 16, 3]): seeded, 3 views an object."""
    rng = np.random.default_rng(0)
    poses = []
    for i in range(N):
        angle = 0.25 * i
        c, s = np.cos(angle), np.sin(angle)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        m[:3, 3] = m[:3, :3] @ np.array([0.0, 0.0, 2.0])
        poses.append(m)
    images = (rng.random((N, RES, RES, 4)) * 2 - 1).astype(np.float32)
    images[..., 3] = (images[..., 3] > 0).astype(np.float32)
    focal = np.full((N,), 1.3, np.float32)
    real = (rng.random((8, 2 * RES, 2 * RES, 4)) * 2 - 1).astype(np.float32)
    z_fid = rng.standard_normal((N, 64)).astype(np.float32)
    inputs = (rng.random((N, RES, RES, 3)) * 2 - 1).astype(np.float32)
    return images, np.stack(poses), focal, real, z_fid, inputs


def _splits():
    images, poses, focal, *_ = _data()
    kw = dict(images=images, tform_cam2world=poses, focal_length=focal)
    return DatasetSplit(**kw), JaxSplit(**kw)


@functools.lru_cache(maxsize=1)
def _real_stats():
    """(port stats, JAX stats) of the real images at the 16^2 evaluation
    resolution: 32^2 images, pooled 2x2, in ragged batches of 3."""
    real = _data()[3]
    port = teval.compute_real_fid_stats(StandIn(STAND_IN_W), real, batch_size=3,
                                        resolution=RES, device="cpu")
    ref = jeval.compute_real_fid_stats(JaxStandIn(), {"w": jnp.asarray(STAND_IN_W)}, real,
                                       batch_size=3, resolution=RES)
    return port, ref


# mode -> (conditional generator, recon_mode)
MODES = {"generation": (False, None), "front": (True, "front"), "random": (True, "random")}


@functools.lru_cache(maxsize=None)
def _jax_recon_fn(conditional):
    """The JAX evaluation batch, jitted once for the front and random modes
    (the same shapes)."""
    jm = (gen_pair(4, use_encoder=True) if conditional else gen_pair(4))[0]
    jlpips, lpips_vars, _ = _lpips_pair()
    return jax.jit(jeval.make_recon_eval_fn(jrender.RenderConfig(**RC_KW), jm, JaxStandIn(),
                                            {"w": jnp.asarray(STAND_IN_W)}, jlpips,
                                            lpips_vars))


@pytest.mark.parametrize("mode", list(MODES))
def test_train_time_evaluation_matches_jax(mode):
    (port_stats, jax_stats) = _real_stats()
    z_fid, inputs = _data()[4:]
    split, jsplit = _splits()
    indices = np.arange(N)
    conditional, recon_mode = MODES[mode]
    jm, variables, tm = gen_pair(4, use_encoder=True) if conditional else gen_pair(4)
    if mode == "generation":
        # The real statistics themselves.
        for got, want in zip(port_stats, jax_stats):
            assert got.dtype == torch.float64
            assert _rel(got, want) < TOL
    tcfg = RenderConfig(**RC_KW)
    fn = teval.make_recon_eval_fn(tcfg, tm, StandIn(STAND_IN_W), _lpips_pair()[2],
                                  device="cpu")
    jfn = _jax_recon_fn(conditional)
    kw = dict(batch_size=BS, recon_mode=recon_mode)
    if recon_mode is not None:
        # The encoder's inputs are indexed by the original evaluation index.
        kw.update(perm_indices=compute_view_perm(indices, 3), views_per_object=3,
                  input_images=inputs)
    got = teval.evaluate_recon(fn, z_fid, split, indices, port_stats, device="cpu", **kw)
    want = jeval.evaluate_recon(jfn, variables, z_fid, jsplit, indices, jax_stats, **kw)
    assert set(got) == set(want)
    scored = {"psnr", "ssim", "lpips", "iou"}
    assert (scored <= set(got)) == (recon_mode is not None)
    for k in set(got) - {"first_batch", "n_images"}:
        assert np.isfinite(got[k]), k
        assert _rel(got[k], want[k]) < TOL, k
    assert got["n_images"] == want["n_images"] == N
    for k, v in want["first_batch"].items():
        assert got["first_batch"][k].shape == (BS, RES, RES) + v.shape[3:], k
        assert _rel(got["first_batch"][k], v) < TOL, k
