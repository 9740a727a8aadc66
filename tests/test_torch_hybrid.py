"""The hybrid inversion on the port against the same chain in JAX.

On tests/test_torch_generator.py's tiny generator,
tests/test_torch_encoder.py's small encoder and an LPIPS of seeded random
features (the same weights in both packages), at 32^2 rays and 8 + 8
samples: the first guess (encoder ->
PnP -> split ws), two 'mse' refinement steps, and the eval metrics before
and after, each within 1e-4 of the JAX package (relative to the largest
value); a render with SDF normals and the coordinate map; and the
inversion report, saved by one package and loaded by the other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.engine import evaluate as jeval
from nerf_from_image_tpu.engine import inversion as jinv
from nerf_from_image_tpu.engine import render as jrender
from nerf_from_image_tpu.models.lpips import LPIPS as JaxLPIPS
from nerf_from_image_tpu.pose import pnp as jpnp
from nerf_from_image_tpu_torch.engine import evaluate as teval
from nerf_from_image_tpu_torch.engine import inversion as tinv
from nerf_from_image_tpu_torch.engine import render as trender
from nerf_from_image_tpu_torch.invert import first_guess
from nerf_from_image_tpu_torch.kernels import splat as tsplat
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.pose import pnp as tpnp
from nerf_from_image_tpu_torch.utils.weights import (
    encoder_state_dict_from_jax,
    lpips_state_dict_from_jax,
)
from tests.test_pnp import synth_problem
from tests.test_torch_encoder import DEPTHS, encoder_pair
from tests.test_torch_generator import (  # noqa: F401
    jax_compiled,
    release_memory,
    tiny_pair,
)
from tests.test_torch_render import SR_INNER, _jax_inversion

TOL = 1e-4
POSE_TOL = 1e-4  # absolute
RES, B = 32, 2
RC_KW = dict(resolution=RES, depth_samples_per_ray=8, scene_range=SR_INNER, query_chunk=None)
FOCAL_GUESSES = tpnp.get_focal_guesses(np.linspace(1.0, 1.6, 20))


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _cameras():
    """Two cameras at distance 2.5 around the origin, focal 1.2."""
    poses = []
    for angle in (0.0, 0.6):
        c, s = np.cos(angle), np.sin(angle)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        m[:3, 3] = m[:3, :3] @ np.array([0.0, 0.0, 2.5])
        poses.append(m)
    return np.stack(poses), np.full((B,), 1.2, np.float32)


@functools.lru_cache(maxsize=1)
def _targets():
    """(target images [B, 32, 32, 4]: the render of seeded ws with its
    mask, true poses, focals, z_avg): what both chains invert."""
    _, _, tm = tiny_pair()
    pose, focal = _cameras()
    rng = np.random.default_rng(5)
    ws = (rng.standard_normal((B, 1, 64)) * 0.5).astype(np.float32)
    with torch.no_grad():
        out, _ = trender.render(trender.RenderConfig(**RC_KW), tm, torch.from_numpy(pose),
                                torch.from_numpy(focal), torch.from_numpy(ws), device="cpu")
    target = torch.cat((out.rgb, out.mask[..., None]), -1).numpy()
    z_avg = (rng.standard_normal((1, tm.num_ws, 64)) * 0.1).astype(np.float32)
    return target, pose, focal, z_avg


@functools.lru_cache(maxsize=1)
def _encoder_pair():
    """tests/test_torch_encoder.py's encoder with its mask logit held at
    -8: no pixel passes PnP's 0.9 threshold, so every sample takes the
    dummy pose. On a random network's coordinate map PnP is ill-posed
    (the best of the focal guesses is a near tie), and its paths are
    held to JAX in tests/test_torch_pnp.py."""
    jenc, enc_vars, _ = encoder_pair()
    enc_vars = jax.tree.map(np.copy, enc_vars)
    enc_vars["params"]["post_4"]["weight"][3] = 0.0
    enc_vars["params"]["post_4"]["bias"][3] = -8.0
    tenc = BootstrapEncoder(64, backbone_depths=DEPTHS, device="cpu")
    tenc.load_state_dict(encoder_state_dict_from_jax(enc_vars), strict=True)
    return jenc, enc_vars, tenc


@functools.lru_cache(maxsize=1)
def _lpips_pair():
    """(JAX LPIPS, its variables, the port's LPIPS with the same weights):
    He-normal VGG16 kernels, small biases and heads from seeded numpy, laid
    out from the abstract init (no JAX initialization to compile)."""
    jm = JaxLPIPS()
    zeros = jnp.zeros((1, RES, RES, 3))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), zeros, zeros)
    rng = np.random.default_rng(9)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):  # HWIO
            fan_in = leaf.shape[0] * leaf.shape[1] * leaf.shape[2]
            v = rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("['bias']"):
            v = rng.standard_normal(leaf.shape) * 0.01
        else:
            v = rng.uniform(0.0, 0.1, leaf.shape)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tm = LPIPS(device="cpu")
    tm.load_state_dict(lpips_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


_jax_estimate = jax.jit(jpnp.estimate_poses_batch)


def _jax_first_guess(coords, mask, w, z_avg, jcfg):
    """invert.py's init block from the encoder's outputs: PnP pose and
    focal, w broadcast to the split ws over lr_gain_z."""
    est_pose, est_focal, _ = _jax_estimate(coords, mask, jnp.asarray(FOCAL_GUESSES))
    z0 = jnp.broadcast_to(w, (B,) + z_avg.shape[1:]) / jcfg.lr_gain_z
    return z0, jinv.pose_params_from_matrix(est_pose, est_focal, False)


@functools.lru_cache(maxsize=1)
def _jax_chain():
    """The JAX package's first guess (invert.py's init block), 2 'mse'
    steps and its eval function at steps 0 and 2, as numpy."""
    jm, variables, _ = tiny_pair()
    jenc, enc_vars, _ = _encoder_pair()
    jl, lpips_vars, _ = _lpips_pair()
    target, pose, focal, z_avg = _targets()
    jcfg = jinv.InversionConfig(steps=2, loss="mse")
    coords, mask, w = jax.jit(lambda v, x: jenc.apply(v, x))(enc_vars, target[..., :3])
    z0, p0 = _jax_first_guess(coords, mask, w, z_avg, jcfg)
    z, p, losses = _jax_inversion(jcfg, jrender.RenderConfig(**RC_KW), target[..., :3],
                                  np.asarray(z0), p0)
    eval_fn = jax.jit(jeval.make_eval_fn(jcfg, jrender.RenderConfig(**RC_KW), jm, variables,
                                         jl, lpips_vars))
    metrics = [jax.tree.map(np.asarray, eval_fn(zz, pp, jnp.asarray(target), jnp.asarray(pose)))
               for zz, pp in ((z0, p0), (z, p))]
    as_np = lambda params: [None if t is None else np.asarray(t) for t in params]  # noqa: E731
    return np.asarray(z0), as_np(p0), np.asarray(z), as_np(p), np.asarray(losses), metrics


def test_first_guess_refinement_and_metrics_match_jax():
    _, _, tm = tiny_pair()
    _, _, tenc = _encoder_pair()
    _, _, tl = _lpips_pair()
    target, pose, focal, z_avg = _targets()
    jz0, jp0, jz, jp, jlosses, jmetrics = _jax_chain()
    tcfg = tinv.InversionConfig(steps=2, loss="mse")
    trc = trender.RenderConfig(plane_splat=True, **RC_KW)
    t_target = torch.from_numpy(target)

    z0, p0 = first_guess(tenc, t_target, torch.from_numpy(z_avg), tcfg, FOCAL_GUESSES,
                         device="cpu")
    assert z0.shape == (B, tm.num_ws, 64)
    assert _rel(z0, jz0) < TOL
    for name, a, b in zip(p0._fields, p0, jp0):
        assert _rel(a, b) < TOL, name

    z, p, losses = tinv.make_invert_fn(tcfg, trc, tm, device="cpu")(z0, p0, t_target)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=TOL)
    assert _rel(z, jz) < TOL
    for name, a, b in zip(p._fields, p, jp):
        assert _rel(a, b) < TOL, name

    eval_fn = teval.make_eval_fn(tcfg, trc, tm, tl, device="cpu")
    for (zz, pp), want in zip(((z0, p0), (z, p)), jmetrics):
        got = eval_fn(zz, pp, t_target, torch.from_numpy(pose))
        assert set(got) == set(want) == {"psnr", "ssim", "iou", "lpips", "rot_error"}
        for k in got:
            assert not got[k].requires_grad
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL, err_msg=k)


class _MapEncoder:
    """Stands in for the encoder: fixed (coordinate map, mask, w)."""

    def __init__(self, coords, mask, w):
        self.outputs = tuple(torch.from_numpy(a) for a in (coords, mask, w))

    def __call__(self, x):
        assert x.shape[-1] == 3
        return self.outputs


def test_first_guess_from_a_solved_pose_matches_jax():
    """The first guess where PnP solves: tests/test_pnp.py's synthetic
    coordinate maps of known cameras (at one of the focal guesses) and
    their masks stand in for the encoder's pose head, in both packages.
    The estimated focal replaces the given one and the solved pose goes
    through pose_params_from_matrix: the pose params within 1e-4
    absolute of JAX, the focal the true one, the cameras the true ones,
    and the split ws within 1e-4 relative."""
    focal = float(np.float32(FOCAL_GUESSES[3]))
    rng = np.random.default_rng(13)
    coords, masks, w2c, _ = synth_problem(rng, B=B, H=RES, W=RES, focal=focal)
    mask = masks.astype(np.float32)
    w = rng.standard_normal((B, 1, 64)).astype(np.float32)
    target, _, _, z_avg = _targets()
    jcfg, tcfg = jinv.InversionConfig(), tinv.InversionConfig()
    jz0, jp0 = _jax_first_guess(jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(w),
                                z_avg, jcfg)
    z0, p0 = first_guess(_MapEncoder(coords, mask, w), torch.from_numpy(target),
                         torch.from_numpy(z_avg), tcfg, FOCAL_GUESSES, device="cpu")
    assert _rel(z0, jz0) < TOL
    for name, a, b in zip(p0._fields, p0, jp0):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=POSE_TOL,
                                   err_msg=name)
    cam, f = tinv.build_camera(p0, tcfg.camera_flipped)
    np.testing.assert_allclose(f.numpy(), focal, rtol=1e-6)
    np.testing.assert_allclose(cam.numpy(), np.linalg.inv(w2c), atol=2e-3)


@functools.lru_cache(maxsize=1)
def _jax_maps_render():
    """The JAX render with normals and coordinates (numpy maps) and its ws."""
    jm, variables, _ = tiny_pair()
    pose, focal = _cameras()
    ws = (np.random.default_rng(7).standard_normal((B, jm.num_ws, 64)) * 0.1).astype(np.float32)
    jcfg = jrender.RenderConfig(compute_normals=True, compute_coords=True, **RC_KW)
    out = jax_compiled(lambda w: jrender.render(jcfg, jm, variables, pose, focal, w,
                                                force_no_cam_grad=True)[0],
                       jnp.asarray(ws))(jnp.asarray(ws))
    return ws, jax.tree.map(np.asarray, out._asdict())


@pytest.mark.parametrize("grad", [False, True])
def test_render_with_normals_and_coordinates_matches_jax(grad, monkeypatch):
    """Under no_grad, values of every map against the JAX render
    (coordinates in the semantics slot); the normals' decode runs the
    splat op's coordinate gradient only, with no plane-gradient call.
    Normals are an evaluation output: with grad mode on and planes that
    require grad (the generator's weights or ws), the render raises."""
    _, _, tm = tiny_pair()
    pose, focal = (torch.from_numpy(a) for a in _cameras())
    ws, jout = _jax_maps_render()
    calls = []
    splat_backward = tsplat.splat3_backward

    def record(*args):
        calls.append(args[-2])
        return splat_backward(*args)

    monkeypatch.setattr(tsplat, "splat3_backward", record)
    cfg = trender.RenderConfig(plane_splat=True, compute_normals=True, compute_coords=True,
                               **RC_KW)

    def render(w):
        return trender.render(cfg, tm, pose, focal, w, force_no_cam_grad=True, device="cpu")[0]

    if grad:
        with pytest.raises(ValueError, match="evaluation output"):
            render(torch.from_numpy(ws).requires_grad_(True))
        assert calls == []
        return
    with torch.no_grad():
        out = render(torch.from_numpy(ws))
    for name in ("rgb", "mask", "depth", "normals", "semantics"):
        assert _rel(getattr(out, name), jout[name]) < TOL, name
        assert not getattr(out, name).requires_grad, name
    assert out.semantics.shape == (B, RES, RES, 3)
    assert calls == []


def test_render_semantics_at_a_height_and_width_matches_jax():
    """RenderConfig.compute_semantics (the palette's probabilities in the
    semantics slot) and a render of height x width rays (24 x 32) against
    the JAX render, values of every map."""
    jm, variables, tm = tiny_pair()
    pose, focal = _cameras()
    ws = (np.random.default_rng(9).standard_normal((B, jm.num_ws, 64)) * 0.1).astype(np.float32)
    jcfg = jrender.RenderConfig(compute_semantics=True, **RC_KW)
    want = jax_compiled(lambda w: jrender.render(jcfg, jm, variables, pose, focal, w,
                                                 height=24, width=32)[0],
                        jnp.asarray(ws))(jnp.asarray(ws))
    with torch.no_grad():
        got = trender.render(trender.RenderConfig(compute_semantics=True, **RC_KW), tm,
                             torch.from_numpy(pose), torch.from_numpy(focal),
                             torch.from_numpy(ws), height=24, width=32, device="cpu")[0]
    assert got.semantics.shape == (B, 24, 32, 4)
    for name in ("rgb", "mask", "depth", "semantics"):
        assert _rel(getattr(got, name), getattr(want, name)) < TOL, name


def _report(pkg, metrics):
    report = pkg.InversionReport([0, 2], {"lpips": "(RANDOM-FEATURE)"})
    for step, m in zip((0, 2), metrics):
        report.add(step, m, {"ws": np.ones((B, 3), np.float32) * step,
                             "R": np.arange(4 * B, dtype=np.float32).reshape(B, 4)})
    return report


def _fid_lines(summary):
    return {line: float(line.split(": ")[1]) for line in summary.splitlines()
            if line.strip().startswith("fid_")}


def test_inversion_report_round_trips_between_packages(tmp_path):
    """A report saved by the port loads in the JAX package and the
    reverse: the same .npz keys, arrays, notes and summary text. Resume
    notes merge alike. With real statistics both summaries add fid_front
    and fid_random per checkpoint (f32 in JAX, float64 in the port: within
    1e-4), and the port's eval function returns the front and novel
    views' Inception activations."""
    rng = np.random.default_rng(8)
    metrics = [{k: rng.random(B).astype(np.float32) for k in ("psnr", "lpips", "lpips_random")}
               for _ in range(2)]
    for m in metrics:
        # 4-d activations of 2 images: rank-deficient statistics, where the
        # JAX package's f32 iteration still converges at this size.
        for view in ("front", "random"):
            m[f"inception_activations_{view}"] = rng.random((B, 4)).astype(np.float32)
    port = _report(teval, [{k: torch.from_numpy(v) for k, v in m.items()} for m in metrics])
    ref = _report(jeval, metrics)
    assert port.summary() == ref.summary()
    for src, dst, name in ((port, jeval, "from_port"), (ref, teval, "from_jax")):
        src.save(str(tmp_path / name / "report"))
        loaded = dst.InversionReport.load(str(tmp_path / name / "report"))
        assert loaded.metric_notes == src.metric_notes
        assert loaded.num_samples() == B
        assert loaded.summary() == ref.summary()
        got, want = loaded.consolidated(), ref.consolidated()
        assert got.keys() == want.keys()
        for step in want:
            assert got[step].keys() == want[step].keys()
            for k in want[step]:
                np.testing.assert_array_equal(got[step][k], want[step][k])
    assert (tmp_path / "from_port" / "report.txt").read_text() == \
        (tmp_path / "from_jax" / "report.txt").read_text()
    for saved, current in (({"lpips": "a"}, {"lpips": "b"}), ({}, {"lpips": "b"}),
                           ({"lpips": "a"}, {})):
        p, r = teval.InversionReport([0], saved), jeval.InversionReport([0], saved)
        p.merge_notes_on_resume(current)
        r.merge_notes_on_resume(current)
        assert p.metric_notes == r.metric_notes
    real = rng.random((6, 4)).astype(np.float32)
    mu, sigma = real.mean(0), np.cov(real, rowvar=False).astype(np.float32)
    got = _fid_lines(port.summary(fid_stats_real=(mu, sigma)))
    want = _fid_lines(ref.summary(fid_stats_real=(jnp.asarray(mu), jnp.asarray(sigma))))
    assert len(want) == 4 and [k.split(":")[0] for k in got] == [k.split(":")[0] for k in want]
    for (_, a), (_, b) in zip(got.items(), want.items()):
        assert np.isfinite(b) and abs(a - b) < TOL * max(abs(b), 1.0)

    # The eval function: the activations of its own renders, and a novel
    # view rendered for them even without a novel-view target.
    stand_in = lambda x: torch.mean(x, dim=(1, 2))  # noqa: E731
    icfg = tinv.InversionConfig()
    eval_fn = teval.make_eval_fn(icfg, trender.RenderConfig(**RC_KW), tiny_pair()[2],
                                 _lpips_pair()[2], inception_model=stand_in, device="cpu")
    target, pose, focal, z_avg = _targets()
    pp = tinv.pose_params_from_matrix(torch.from_numpy(pose), torch.from_numpy(focal), False)
    z = torch.from_numpy(np.repeat(z_avg, B, 0)) / icfg.lr_gain_z
    res = eval_fn(z, pp, torch.from_numpy(target), perm_pose=torch.from_numpy(pose[::-1].copy()),
                  perm_focal=torch.from_numpy(focal))
    with torch.no_grad():
        out = trender.render(trender.RenderConfig(**RC_KW), tiny_pair()[2],
                             torch.from_numpy(pose[::-1].copy()), torch.from_numpy(focal),
                             torch.from_numpy(np.repeat(z_avg, B, 0)), device="cpu")[0]
    assert "psnr_random" not in res
    torch.testing.assert_close(res["inception_activations_random"],
                               stand_in(torch.clamp(out.rgb, -1, 1) / 2 + 0.5))
    assert res["inception_activations_front"].shape == (B, 3)
