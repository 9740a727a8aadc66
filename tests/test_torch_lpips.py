"""The port's LPIPS (models/lpips.py), its weight mappers (utils/weights.py)
and image metrics (metrics/image.py) against the JAX package.

LPIPS is the full VGG16 trunk with flax's random weights carried over
(HWIO -> OIHW), on 32x32 images; features, distance and the input
gradient agree at 1e-5 of the largest value. The `lpips`-package mappers
get one synthetic state dict with that package's key names.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.engine import augment as jaug
from nerf_from_image_tpu.engine import inversion as jinv
from nerf_from_image_tpu.metrics import image as jimage
from nerf_from_image_tpu.models import lpips as jlpips
from nerf_from_image_tpu_torch.engine import augment as taug
from nerf_from_image_tpu_torch.engine import inversion as tinv
from nerf_from_image_tpu_torch.metrics import image as timage
from nerf_from_image_tpu_torch.models import lpips as tlpips
from nerf_from_image_tpu_torch.utils import weights
from tests.test_torch_generator import lpips_pair, release_memory  # noqa: F401

TOL = 1e-5


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _images(seed, n=2, res=32):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, res, res, 3)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _jax_lpips():
    """The JAX LPIPS's jitted features(variables, x) and (distance, d
    distance / d x0)(x0, variables, x1): the variables are arguments, so
    the tests of the module share one compile per input shape."""
    jm = lpips_pair()[0]
    features = jax.jit(lambda v, a: jm.apply(v, a, method="features"))
    distance = jax.jit(jax.value_and_grad(lambda a, v, b: jnp.sum(jm.apply(v, a, b))))
    return features, distance


def _compare(variables, tm, x0, x1, tol=TOL):
    """Features, distance and d distance / d x0 of both packages."""
    jfeatures, jdistance = _jax_lpips()
    jf = jfeatures(variables, jnp.asarray(x0))
    tf = tm.features(torch.from_numpy(x0))
    assert len(tf) == 5
    for t, j in zip(tf, jf):
        assert _rel(t, j) < tol
    jd, jg = jdistance(jnp.asarray(x0), variables, jnp.asarray(x1))
    t0 = torch.from_numpy(x0).requires_grad_(True)
    td = tm(t0, torch.from_numpy(x1))
    assert td.shape == (x0.shape[0], 1)
    td.sum().backward()
    assert _rel(td.sum(), jd) < tol
    assert np.isfinite(t0.grad.numpy()).all()
    assert _rel(t0.grad, jg) < tol
    return tf, td


def test_lpips_features_distance_and_gradient_match_jax():
    _, variables, tm = lpips_pair()
    x0, x1 = _images(0), _images(1)
    _, td = _compare(variables, tm, x0, x1)
    assert torch.all(td > 0)
    # Cached target features give the same distance.
    cached = tm(torch.from_numpy(x0), tm.features(torch.from_numpy(x1)))
    assert torch.allclose(cached, td, rtol=1e-6)


def test_lpips_gradient_is_finite_at_all_zero_taps():
    """Where a whole tap vector is 0 (every relu off), normalize_tensor's
    sqrt has an infinite slope; both packages mask it through the relu and
    give the same finite input gradient. Pixels whose tap is barely above
    0 normalize a few tiny values, which magnifies the summation-order
    differences of the convolutions: 1e-4 here."""
    _, variables, _ = lpips_pair()
    params = jax.tree.map(np.array, variables)
    params["params"]["net"]["conv1"]["bias"] -= 2.0  # ~40% of tap-0 pixels all 0
    x0, x1 = _images(2), _images(3)
    tm2 = tlpips.LPIPS(device="cpu")
    tm2.load_state_dict(weights.lpips_state_dict_from_jax(params), strict=True)
    tf, _ = _compare(jax.tree.map(jnp.asarray, params), tm2, x0, x1, tol=1e-4)
    norms = tf[0].norm(dim=-1)
    assert bool((norms == 0).any()) and bool((norms > 0).any())


@pytest.mark.parametrize("loss,white_background", [
    ("vgg", False), ("vgg", True), ("vgg_nocrop", False), ("mixed", False), ("l1", False),
    ("mse", False)])
def test_reconstruction_loss_matches_jax(loss, white_background, monkeypatch):
    """Each loss and its gradient w.r.t. the render, with cached target
    features, 2 crop augmentations and one transform handed to both."""
    jm, variables, tm = lpips_pair()
    pred, target = _images(5, n=2), _images(6, n=2)
    rng = np.random.default_rng(7)
    tform = (rng.uniform(-np.pi, np.pi, 4), np.exp2(rng.standard_normal(4) * 0.2),
             rng.standard_normal((4, 2)) * 0.1)
    tform = [t.astype(np.float32) for t in tform]
    kw = dict(loss=loss, num_augmentations=2, white_background=white_background)
    monkeypatch.setattr(jaug, "sample_transform",
                        lambda *a, **k: jaug.AugmentTransform(*map(jnp.asarray, tform)))
    perceptual = loss in ("vgg", "vgg_nocrop", "mixed")
    jfeat = _jax_lpips()[0](variables, jnp.asarray(target)) if perceptual else None
    jl, jg = jax.jit(jax.value_and_grad(lambda x, v, f: jinv.reconstruction_loss(
        jinv.InversionConfig(**kw), jm, v, x, jnp.asarray(target), f, None)))(
        jnp.asarray(pred), variables, jfeat)
    x = torch.from_numpy(pred).requires_grad_(True)
    tfeat = tm.features(torch.from_numpy(target)) if perceptual else None
    tl = tinv.reconstruction_loss(
        tinv.InversionConfig(**kw), tm if perceptual else None, x, torch.from_numpy(target),
        tfeat, tform=taug.AugmentTransform(*map(torch.from_numpy, tform)))
    tl.backward()
    assert _rel(tl, jl) < TOL
    assert _rel(x.grad, jg) < TOL


def _lpips_package_state(variables, prefix="net.slice"):
    """A state dict with the `lpips` package's key names and layouts
    (OIHW trunk, [1, C, 1, 1] heads) holding the JAX variables."""
    net = variables["params"]["net"]
    state = {}
    for i, pos in enumerate((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)):
        key = (f"net.features.{pos}" if prefix == "features"
               else f"net.slice{weights._slice_of(pos)}.{pos}")
        state[f"{key}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(net[f"conv{i}"]["kernel"]), (3, 2, 0, 1))))
        state[f"{key}.bias"] = torch.from_numpy(np.array(net[f"conv{i}"]["bias"]))
    for i in range(5):
        state[f"lin{i}.model.1.weight"] = torch.from_numpy(
            np.array(variables["params"][f"lin{i}"]).reshape(1, -1, 1, 1))
    return state


@pytest.mark.parametrize("prefix", ["slice", "features"])
def test_lpips_package_state_maps_like_the_jax_mapper(prefix):
    jm, variables, _ = lpips_pair()
    state = _lpips_package_state(variables, prefix)
    sd = weights.lpips_state_to_state_dict(state)
    tm = tlpips.LPIPS(device="cpu")
    tm.load_state_dict(sd, strict=True)
    # The JAX package's mapper, fed the same state, gives the same weights.
    jvars = jlpips.lpips_state_to_variables(
        jax.tree.map(np.zeros_like, variables), {k: v.numpy() for k, v in state.items()})
    assert set(sd) == set(weights.lpips_state_dict_from_jax(jax.tree.map(np.asarray, jvars)))
    for k, v in weights.lpips_state_dict_from_jax(jax.tree.map(np.asarray, jvars)).items():
        assert torch.equal(sd[k], v), k
    state.pop("lin3.model.1.weight")
    with pytest.raises(KeyError):
        weights.lpips_state_to_state_dict(state)


def test_make_lpips_loads_a_weights_file_or_warns(tmp_path, monkeypatch):
    _, variables, ref = lpips_pair()
    path = tmp_path / "vgg.pth"
    torch.save(_lpips_package_state(variables), path)
    monkeypatch.setenv("NFI_LPIPS_WEIGHTS", str(path))
    model = tlpips.make_lpips(device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    monkeypatch.setenv("NFI_LPIPS_WEIGHTS", str(tmp_path / "missing.pth"))
    with pytest.warns(UserWarning, match="RANDOM"):
        tlpips.make_lpips(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_image_metrics_match_jax(masked):
    rng = np.random.default_rng(4)
    pred = rng.uniform(-0.1, 1.1, (3, 20, 18, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(size=(3, 20, 18)) > 0.4).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    for reduction in ("mean", "none"):
        assert _rel(timage.psnr(torch.from_numpy(pred), torch.from_numpy(target), reduction, tmask),
                    jimage.psnr(jnp.asarray(pred), jnp.asarray(target), reduction, jmask)) < TOL
        assert _rel(timage.ssim(torch.from_numpy(pred), torch.from_numpy(target), reduction),
                    jimage.ssim(jnp.asarray(pred), jnp.asarray(target), reduction)) < TOL
        a0, a1 = pred[..., 0], target[..., 1]
        assert _rel(timage.iou(torch.from_numpy(a0), torch.from_numpy(a1), reduction),
                    jimage.iou(jnp.asarray(a0), jnp.asarray(a1), reduction)) < TOL
