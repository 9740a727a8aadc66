"""The port's SegFormer and BootstrapEncoder against the JAX package.

Small backbones (one block a stage, MiT-B5's widths) on <= 64^2 images,
f32. The JAX variable tree is built from its abstract shapes and filled
with seeded numpy weights (no JAX initialization to compile); the port
loads it through utils/weights.py::encoder_state_dict_from_jax, strictly.
Outputs agree within 1e-4 of the largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.encoder import BootstrapEncoder as JaxEncoder
from nerf_from_image_tpu.models.encoder import encoder_rename as jax_encoder_rename
from nerf_from_image_tpu.models.segformer import Segformer as JaxSegformer
from nerf_from_image_tpu_torch.models import segformer as tseg
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder, encoder_rename
from nerf_from_image_tpu_torch.utils.weights import encoder_state_dict_from_jax
from tests.test_torch_generator import release_memory  # noqa: F401

DEPTHS = (1, 1, 1, 1)
TOL = 1e-4


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def seeded_variables(module, x_shape, seed):
    """{'params': tree} of numpy weights for a flax module, from its
    abstract init: convs normal with std sqrt(2 / fan_out) as the JAX
    initializer, linears std 0.02, LayerNorm scales 1 + N(0, 0.1), biases
    N(0, 0.02) (non-zero, so that every bias is exercised)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(x_shape))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['bias']"):
            v = rng.standard_normal(shape) * 0.02
        elif len(shape) == 4:  # OIHW; one input channel a group: depthwise
            fan_out = shape[2] * shape[3] * (1 if shape[1] == 1 else shape[0])
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_out)
        elif len(shape) == 2:
            v = rng.standard_normal(shape) * 0.02
        else:
            v = 1.0 + rng.standard_normal(shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _paths(tree):
    """[(dot-joined path, leaf)] of a nested dict of arrays."""
    return [(".".join(str(k.key) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def encoder_pair(separate_backbones=False, latent_dim=64, image=32):
    """(JAX encoder, its numpy variables, the port's encoder with the same
    weights) at DEPTHS; shared by the hybrid tests."""
    jm = JaxEncoder(latent_dim=latent_dim, separate_backbones=separate_backbones,
                    backbone_depths=DEPTHS)
    variables = seeded_variables(jm, (1, image, image, 3), seed=int(separate_backbones))
    tm = BootstrapEncoder(latent_dim, separate_backbones=separate_backbones,
                          backbone_depths=DEPTHS, device="cpu")
    tm.load_state_dict(encoder_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


@functools.lru_cache(maxsize=None)
def _jax_apply(jm):
    return jax.jit(lambda v, x: jm.apply(v, x))


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


def test_segformer_matches_jax():
    """The backbone alone on a 64^2 image: every stage has a 2x2 or larger
    map after its spatial reduction, and the head upsamples by 2, 4, 8."""
    jm = JaxSegformer(out_features=512, depths=DEPTHS)
    variables = seeded_variables(jm, (1, 64, 64, 3), seed=2)
    tm = tseg.Segformer(depths=DEPTHS, device="cpu")
    tm.load_state_dict({tseg.segformer_rename(k): torch.from_numpy(v)
                        for k, v in _paths(variables["params"])}, strict=True)
    x = _images((1, 64, 64, 3), 3)
    want = np.asarray(_jax_apply(jm)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (1, 16, 16, 512)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("separate_backbones", [False, True])
def test_bootstrap_encoder_matches_jax(separate_backbones):
    jm, variables, tm = encoder_pair(separate_backbones)
    x = _images((2, 32, 32, 3), 4)
    want = _jax_apply(jm)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for name, a, b, shape in zip(("coords", "mask", "w"), got, want,
                                 ((2, 32, 32, 3), (2, 32, 32), (2, 1, 64))):
        assert a.shape == shape, name
        assert _rel(a, b) < TOL, name


def test_state_dict_keys_are_encoder_rename_of_the_jax_paths():
    """The port's parameter names are the reference's state-dict keys:
    encoder_rename (the port's copy) of every JAX path, equal to the JAX
    package's own rename; a missing key fails the strict load."""
    _, variables, tm = encoder_pair(True)
    paths = [p for p, _ in _paths(variables["params"])]
    keys = {encoder_rename(p) for p in paths}
    assert keys == {jax_encoder_rename(p) for p in paths} == set(tm.state_dict())
    for key in ("backbone.block3.0.mlp.dwconv.dwconv.weight", "backbone.linear_c4.proj.weight",
                "backbone.block1.0.attn.sr.weight", "backbone_latent.norm4.bias",
                "post.4.bias", "w_regressor_pre.0.weight", "w_regressor_post.2.weight"):
        assert key in keys, key
    sd = encoder_state_dict_from_jax(variables)
    sd.pop("post.2.weight")
    with pytest.raises(RuntimeError):
        tm.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_bilinear_matches_jax_image_resize(factor):
    """Integer-factor upsampling, the only resize the encoder makes: equal
    to jax.image.resize's bilinear, border rows and columns included."""
    x = _images((2, 5, 3, 7), 5)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 5 * factor, 3 * factor, 7),
                                       "bilinear"))
    got = tseg._resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                                (5 * factor, 3 * factor)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_drop_path_draws_from_its_generator():
    """Identity when deterministic or at rate 0; otherwise whole samples
    are zeroed or scaled by 1/keep, the same ones for the same seed."""
    x = torch.ones(64, 5, 3)
    assert tseg.drop_path(x, 0.3, True) is x and tseg.drop_path(x, 0.0, False) is x
    a = tseg.drop_path(x, 0.25, False, torch.Generator().manual_seed(1))
    b = tseg.drop_path(x, 0.25, False, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    per_sample = a[:, 0, 0]
    assert set(per_sample.tolist()) <= {0.0, float(torch.tensor(1.0) / 0.75)}
    assert torch.equal(a, per_sample[:, None, None].expand_as(a))
    assert 0 < int((per_sample == 0).sum()) < 64
