"""FID on the port against the JAX package: the statistics and the Frechet
distance (metrics/fid.py), the full FIDInceptionV3 (models/inception.py)
and the pytorch-fid weight reader (utils/weights.py).

The Inception weights are seeded numpy values laid out by the JAX
module's abstract initialization (no initialization to compile): He-normal
convolutions and batch norms with non-trivial running statistics, so that
every layer is exercised. The JAX network is compiled once per input
size; its input resize is jax.image.resize, as FIDInceptionV3 calls it.
Activations agree within 1e-4 of the largest, the statistics and the
distance within 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.metrics import fid as jfid
from nerf_from_image_tpu.models import inception as jinc
from nerf_from_image_tpu_torch.metrics import fid as tfid
from nerf_from_image_tpu_torch.models import inception as tinc
from nerf_from_image_tpu_torch.utils import weights
from tests.test_torch_generator import release_memory  # noqa: F401

TOL = 1e-4
D = 64


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


@functools.lru_cache(maxsize=1)
def _activations():
    """Two sets of [N, D] activations with full-rank covariances (N > D),
    where 30 f32 Newton-Schulz iterations converge in both packages."""
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    a = (rng.standard_normal((3 * D // 2, D)).astype(np.float32) @ mix + 0.3).astype(np.float32)
    b = (rng.standard_normal((2 * D, D)) * 1.5).astype(np.float32)
    return a, b


def test_fid_statistics_root_and_distance_match_jax():
    """calculate_stats, sqrtm_newton_schulz, trace_sqrt_product and
    frechet_distance (also with the real statistics as numpy arrays, as a
    report hands them over), each against the JAX package's."""
    a, b = _activations()
    jstats = [jfid.calculate_stats(jnp.asarray(x)) for x in (a, b)]
    tstats = [tfid.calculate_stats(torch.from_numpy(x)) for x in (a, b)]
    for (tm, ts), (jm, js) in zip(tstats, jstats):
        assert _rel(tm, jm) < TOL and _rel(ts, js) < TOL
        assert _rel(tfid.sqrtm_newton_schulz(ts), jfid.sqrtm_newton_schulz(js)) < TOL
    got = tfid.trace_sqrt_product(tstats[0][1], tstats[1][1])
    assert _rel(got, jfid.trace_sqrt_product(jstats[0][1], jstats[1][1])) < TOL
    got = tfid.frechet_distance(*tstats[0], *tstats[1])
    want = jfid.frechet_distance(*jstats[0], *jstats[1])
    assert got.dtype == torch.float32
    assert _rel(got, want) < TOL
    mixed = tfid.frechet_distance(*tstats[0], *(s.numpy() for s in tstats[1]))
    assert _rel(mixed, want) < TOL


def _eigen_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """The Frechet distance in float64 from the eigenvalues of S1 S2."""
    s1 = sigma1 + eps * np.eye(len(mu1))
    s2 = sigma2 + eps * np.eye(len(mu1))
    tr = np.sum(np.sqrt(np.linalg.eigvals(s1 @ s2).astype(complex))).real
    return float(np.sum((mu1 - mu2) ** 2) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr)


def _fails(distance, want):
    return not np.isfinite(distance) or abs(distance - want) > 100 * TOL * abs(want)


# Rows of the first activation set: fewer than D (both covariances
# singular) or more (only the second one).
RANK_DEFICIENT = {"both_singular": D // 2, "one_singular": 2 * D}


@pytest.mark.parametrize("case", list(RANK_DEFICIENT))
def test_float64_distance_of_rank_deficient_statistics(case):
    """Fewer activations than dimensions give singular covariances. There
    the JAX package's f32 distance (the reference's dtype) fails, NaN or
    far from the eigenvalue reference, and the port's algorithm in f32
    fails as it does; in float64 (metrics/fid.py::FID_DTYPE, which the
    drivers hand over) the port converges to the reference. This is why
    the port's drivers leave the JAX package's dtype."""
    n = RANK_DEFICIENT[case]
    rng = np.random.default_rng(n)
    a = np.maximum(rng.standard_normal((n, D)) @ rng.standard_normal((D, D)) / 8, 0)
    b = np.maximum(rng.standard_normal((D // 4, D)) + 0.2, 0)
    stats = [tfid.calculate_stats(torch.from_numpy(x)) for x in (a, b)]
    want = _eigen_distance(*(s.numpy() for s in stats[0]), *(s.numpy() for s in stats[1]))
    assert tfid.FID_DTYPE == torch.float64
    got = float(tfid.frechet_distance(*(s.to(tfid.FID_DTYPE) for s in stats[0] + stats[1])))
    assert abs(got - want) < TOL * abs(want)
    jstats = [jfid.calculate_stats(jnp.asarray(x, jnp.float32)) for x in (a, b)]
    assert _fails(float(jfid.frechet_distance(*jstats[0], *jstats[1])), want)
    assert _fails(float(tfid.frechet_distance(*(s.float() for s in stats[0] + stats[1]))),
                  want)


@functools.lru_cache(maxsize=1)
def _inception_variables():
    """JAX FIDInceptionV3 variables ('params', 'buffers') of seeded numpy
    values: He-normal OIHW kernels, batch-norm scales 1 + N(0, 0.1), biases
    and running means N(0, 0.1), running variances 1 + |N(0, 0.1)|."""
    shapes = jax.eval_shape(jinc.FIDInceptionV3(resize_input=False).init,
                            jax.random.key(0), jnp.zeros((1, 75, 75, 3)))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['conv_weight']"):
            fan_in = int(np.prod(leaf.shape[1:]))
            v = rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("['bn_weight']"):
            v = 1.0 + rng.standard_normal(leaf.shape) * 0.1
        elif name.endswith("['bn_running_var']"):
            v = 1.0 + np.abs(rng.standard_normal(leaf.shape)) * 0.1
        else:
            v = rng.standard_normal(leaf.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=1)
def _port_inception():
    model = tinc.FIDInceptionV3(device="cpu")
    model.load_state_dict(weights.inception_state_dict_from_jax(_inception_variables()),
                          strict=True)
    return model


_jax_body = jax.jit(lambda v, x: jinc.FIDInceptionV3(resize_input=False).apply(v, x))


# (input size, resize_input): no resize at Inception's smallest input, an
# upsampling and an (antialiased) downsampling resize.
INCEPTION_CASES = {"75_as_is": (75, False), "64_up": (64, True), "320_down": (320, True)}


@pytest.mark.parametrize("case", list(INCEPTION_CASES))
def test_inception_activations_match_jax(case):
    size, resize = INCEPTION_CASES[case]
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    if resize:
        # FIDInceptionV3.__call__: jax.image.resize, then the network.
        x_in = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear")
    else:
        x_in = jnp.asarray(x)
    want = np.asarray(_jax_body(_inception_variables(), x_in))
    model = _port_inception()
    model.resize_input = resize
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(x))
    finally:
        model.resize_input = True
    assert got.shape == (2, 2048)
    assert np.abs(want).max() > 0.1
    assert _rel(got, want) < TOL


def test_resize_matches_jax_image_resize():
    """The written-out triangle filter against jax.image.resize, shrinking
    (antialiased) and growing along each axis, within 1e-5 of the largest
    value (the two compute the filter weights in different precisions)."""
    x = np.random.default_rng(1).random((2, 3) + (23, 31)).astype(np.float32)
    for shape in ((5, 9), (40, 17), (299, 299)):
        want = jax.image.resize(jnp.asarray(x), (2, 3) + shape, method="bilinear")
        got = tinc.resize_bilinear(torch.from_numpy(x), shape)
        assert _rel(got, want) < 1e-5, shape


def test_load_inception_weights_matches_jax_reader(tmp_path):
    """A pytorch-fid-named file (with the classifier, the auxiliary head and
    num_batches_tracked, which both readers drop) gives the port the
    weights the JAX package's inception_state_to_variables reads."""
    variables = _inception_variables()
    state = {k: v.clone() for k, v in weights.inception_state_dict_from_jax(variables).items()}
    state["fc.weight"] = torch.zeros((1008, 2048))
    state["fc.bias"] = torch.zeros((1008,))
    state["AuxLogits.conv0.conv.weight"] = torch.zeros((128, 768, 1, 1))
    state["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    path = str(tmp_path / "pt_inception.pth")
    torch.save(state, path)
    loaded = weights.load_inception_weights(path)
    model = tinc.FIDInceptionV3(device="cpu")
    model.load_state_dict(loaded, strict=True)
    jax_read = jinc.inception_state_to_variables(
        jax.tree.map(np.zeros_like, variables),
        {k: v.numpy() for k, v in state.items()})
    want = weights.inception_state_dict_from_jax(jax_read)
    assert set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
