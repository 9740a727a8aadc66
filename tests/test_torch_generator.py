"""The port's Generator against the JAX package at a tiny config, in f32.

The JAX Generator is initialized with flax; its variables carry over to
the port through utils/weights.py (strict load), so both packages compute
the same function on the same seeded numpy inputs.
"""

import ctypes
import functools
import gc
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.models.lpips import LPIPS as JaxLPIPS
from nerf_from_image_tpu.ops.triplane import pack_corners as jax_pack_corners
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.ops.triplane import pack_corners
from nerf_from_image_tpu_torch.utils.weights import lpips_state_dict_from_jax, state_dict_from_jax

# JAX references that are traced once and run a few times at tiny shapes
# compile ~30% sooner with LLVM at -O0 (not those that run wide
# convolutions: XLA:CPU runs them much slower there).
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jax_compiled(fn, *args):
    """fn jitted and compiled for `args` with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def built_once(tmp_path_factory, name, build):
    """`build(root)` -> a picklable result, run once per test session for a
    fixture that several tests share (root: an empty directory the build
    may fill). Under pytest-xdist every worker that draws one of those
    tests would build it again: the workers share <basetemp>/../<name>,
    the first to take the lock builds there and pickles the result, and
    the others wait for it and load it."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's directory, above the workers'
    root = base / name
    done = root / "built.pkl"
    with FileLock(str(root) + ".lock"):
        if done.exists():
            with open(done, "rb") as f:
                return pickle.load(f)
        shutil.rmtree(root, ignore_errors=True)  # a build that failed
        root.mkdir()
        result = build(root)
        with open(str(done) + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(str(done) + ".tmp", done)
        return result


# The render-level config of tests/test_splat.py.
TINY = dict(latent_dim=64, scene_range=1.4, attention_values=4, use_sdf=True,
            w_dim=64, plane_channels=32, synthesis_resolution=64,
            channel_base=2048, channel_max=64)


@functools.lru_cache(maxsize=1)
def tiny_pair():
    """(JAX model, its variables, the port's model with the same weights)."""
    jm = JaxGenerator(**TINY)
    variables = jax.jit(lambda k: jm.init(k, method="init_all"))(jax.random.key(0))
    tm = Generator(**TINY, device="cpu")
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    tm.load_state_dict(sd, strict=True)
    return jm, variables, tm


@functools.lru_cache(maxsize=1)
def lpips_pair():
    """(JAX LPIPS, its variables, the port's LPIPS with the same weights):
    the full VGG16 trunk with flax's random initialization."""
    jm = JaxLPIPS()
    zeros = jnp.zeros((1, 16, 16, 3))
    variables = jax.jit(jm.init)(jax.random.key(1), zeros, zeros)
    tm = LPIPS(device="cpu")
    tm.load_state_dict(lpips_state_dict_from_jax(jax.tree.map(np.asarray, variables)),
                       strict=True)
    return jm, variables, tm


def seeded_generator_variables(jm, seed):
    """The variable tree of a JAX generator from its abstract init, with
    seeded values (no initialization to compile): weights N(0, 1), biases
    N(0, 0.1), beta and alpha 1 + N(0, 0.1), noise strengths 0."""
    shapes = jax.eval_shape(lambda k: jm.init(k, method="init_all"), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            v = rng.standard_normal(leaf.shape) * 0.1
        elif name.endswith(("['beta']", "['alpha']")):
            v = 1.0 + np.abs(rng.standard_normal(leaf.shape)) * 0.1
        elif name.endswith("['noise_strength']"):
            v = np.zeros(leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(autouse=True, scope="module")
def release_memory():
    """Runs a module's tests on one torch thread, then hands back what they
    held. Test workers live for the whole suite, which runs several of
    them side by side with its training and multi-host tests: torch's
    default of one thread per core oversubscribes the CPU, and JAX's
    compile caches and the heap's freed arenas would otherwise stay
    resident in the worker. Every test_torch_* module imports this.

    The model pairs (tiny_pair, lpips_pair: ~120 MB of weights) stay
    cached: a worker that re-enters a module would otherwise pay their
    JAX initialization, a compile, each time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL(None).malloc_trim(0)


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def test_weight_carry_over_is_strict():
    jm, variables, tm = tiny_pair()
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(tm.state_dict())
    assert "mapping_network.backbone.fc0.weight" in sd
    assert "decoder.net.2.weight" in sd
    assert "synthesis_network.b4.conv1.noise_const" in sd
    sd.pop("decoder.net.0.bias")
    with pytest.raises(RuntimeError):
        tm.load_state_dict(sd, strict=True)


def test_mapping_synthesis_and_texture():
    jm, variables, tm = tiny_pair()
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 64)).astype(np.float32)
    ws = (rng.standard_normal((2, jm.num_ws, 64)) * 0.3).astype(np.float32)
    # One jitted JAX program for the four references.
    jws, jplanes, ja = jax.jit(lambda v, z, ws: (
        jm.apply(v, z, method="mapping"),
        {mode: jm.apply(v, ws, mode, None, method="synthesize") for mode in ("none", "const")},
        jm.apply(v, ws, method="texture"),
    ))(variables, jnp.asarray(z), jnp.asarray(ws))
    tws = tm.mapping(torch.from_numpy(z))
    assert _rel(tws, jws) < 1e-5
    for mode in ("none", "const"):
        tp = tm.synthesize(torch.from_numpy(ws), mode)
        assert tp.shape == (2, 3, 64, 64, 32)
        assert _rel(tp, jplanes[mode]) < 1e-5, mode
    assert _rel(tm.texture(torch.from_numpy(ws)), ja) < 1e-5
    avg = tm.average_w(n_samples=256)
    assert avg.shape == (1, jm.num_ws, 64) and torch.isfinite(avg).all()


@functools.lru_cache(maxsize=1)
def _jax_planes_and_texture():
    """The JAX planes and palette of the sample-field tests' ws (their
    first draw from default_rng(1)), one jitted call shared by both
    routes."""
    jm, variables, _ = tiny_pair()
    ws = (np.random.default_rng(1).standard_normal((1, jm.num_ws, 64)) * 0.3).astype(np.float32)
    return jax.jit(lambda v, w: (jm.apply(v, w, method="synthesize"),
                                 jm.apply(v, w, method="texture")))(variables, jnp.asarray(ws))


_FIELD_OUTPUTS = ("sigma", "rgb", "semantics", "sdf_distance")


@functools.lru_cache(maxsize=1)
def _jax_sample_field():
    """The sample-field tests' inputs (planes, palette, points, cotangents)
    and the JAX reference (field values, d planes, d points), computed
    once for both routes."""
    jm, variables, _ = tiny_pair()
    rng = np.random.default_rng(1)
    rng.standard_normal((1, jm.num_ws, 64))  # the ws draw of _jax_planes_and_texture
    planes, attn = (np.array(a) for a in _jax_planes_and_texture())
    points = rng.uniform(-1.6, 1.6, (1, 600, 3)).astype(np.float32)
    points[0, :3] = [[1.4, 0.2, -0.3], [-1.4, 1.4, 0.0], [0.5, -1.4, 1.4]]  # on the box
    cot = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in (("sigma", (1, 600)), ("rgb", (1, 600, 3)),
                        ("semantics", (1, 600, 4)), ("sdf_distance", (1, 600, 1)))}

    def jfn(planes, points):
        res = jm.apply(variables, jax_pack_corners(planes), points, jnp.asarray(attn),
                       outputs=_FIELD_OUTPUTS, method="sample_field")
        return sum(jnp.sum(res[k] * cot[k]) for k in _FIELD_OUTPUTS), res

    (_, jres), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(planes), jnp.asarray(points))
    return (planes, attn, points, cot), (jres, jgp, jgx)


@pytest.mark.parametrize("route", ["packed", "splat"])
def test_sample_field_values_and_gradients(route):
    _, _, tm = tiny_pair()
    (planes, attn, points, cot), (jres, jgp, jgx) = _jax_sample_field()
    outputs = _FIELD_OUTPUTS
    tp = torch.from_numpy(planes).requires_grad_(True)
    tx = torch.from_numpy(points).requires_grad_(True)
    if route == "splat":
        tres = tm.sample_field(tp, tx, torch.from_numpy(attn), outputs=outputs, splat=True)
    else:
        tres = tm.sample_field(pack_corners(tp), tx, torch.from_numpy(attn), outputs=outputs)
    sum(torch.sum(tres[k] * torch.from_numpy(cot[k])) for k in outputs).backward()
    for k in outputs:
        assert _rel(tres[k], jres[k]) < 1e-5, k
    assert _rel(tp.grad, jgp) < 1e-5
    assert _rel(tx.grad, jgx) < 1e-5


@pytest.mark.parametrize("kernel_size,up,down", [(3, False, False), (3, True, False),
                                                 (3, False, True), (1, False, True)])
def test_equalized_conv_with_resampling(kernel_size, up, down):
    from nerf_from_image_tpu.models.layers import EqualizedConv2d as JaxConv
    from nerf_from_image_tpu_torch.models.layers import EqualizedConv2d

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)  # NHWC
    jconv = JaxConv(5, 6, kernel_size, activate=True, up=up, down=down)
    params = jconv.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1, params)  # a nonzero bias
    jy = jconv.apply(params, jnp.asarray(x), gain=0.7)
    tconv = EqualizedConv2d(5, 6, kernel_size, activate=True, up=up, down=down)
    tconv.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params["params"].items()})
    ty = tconv(torch.from_numpy(x).permute(0, 3, 1, 2), gain=0.7).permute(0, 2, 3, 1)
    assert ty.shape == jy.shape
    assert _rel(ty, jy) < 1e-5
