"""GAN training's modules, one G step and one D step of the port against the
JAX package, at tests/test_gan_engine.py::tiny_models' sizes, in f32.

Weights are seeded numpy values laid out by the JAX modules' abstract
initialization (no initialization to compile) and carried to the port
through utils/weights.py. The two packages draw their random streams
differently, so the port's steps take their draws handed in (latents,
augmentation transforms, regularizer samples and noise) and, on the JAX
side, the module attributes that draw are patched to return the same
values during the trace: `gan.render` runs with key=None (the
deterministic render), `regularizers.sample_volume_stratified`,
`augment.sample_transform` and `jax.random.normal` (by shape). To read
the JAX steps' gradients, their optimizer is replaced by the identity
and the SDF clamp by a no-op, so the returned parameters are the
gradients; the port's optimizer step records its gradients. The two
packages' updated parameters are not compared: with b1 = 0 the first
Adam step is lr * g / (|g| + eps), whose sign flips for a gradient entry
near eps. The optimizer is compared on shared gradients instead.
Tolerances are relative to the largest value of each compared array.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from nerf_from_image_tpu.engine import augment as jaug
from nerf_from_image_tpu.engine import gan as jgan
from nerf_from_image_tpu.engine import regularizers as jreg
from nerf_from_image_tpu.engine import render as jrender
from nerf_from_image_tpu.models import discriminator as jdisc_mod
from nerf_from_image_tpu.models import stylegan as jsg
from nerf_from_image_tpu.models.discriminator import Discriminator as JaxDiscriminator
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.models.generator import ResidualEncoder as JaxResidualEncoder
from nerf_from_image_tpu.ops import filters as jfilters
from nerf_from_image_tpu.ops import sampling as jsampling
from nerf_from_image_tpu_torch.engine import augment as taug
from nerf_from_image_tpu_torch.engine import gan as tgan
from nerf_from_image_tpu_torch.engine import regularizers as treg
from nerf_from_image_tpu_torch.engine.render import RenderConfig
from nerf_from_image_tpu_torch.models import discriminator as tdisc_mod
from nerf_from_image_tpu_torch.models import stylegan as tsg
from nerf_from_image_tpu_torch.models.discriminator import Discriminator
from nerf_from_image_tpu_torch.models.generator import Generator, ResidualEncoder
from nerf_from_image_tpu_torch.ops import conv as conv_ops
from nerf_from_image_tpu_torch.ops import filters as tfilters
from nerf_from_image_tpu_torch.ops import sampling as tsampling
from nerf_from_image_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_generator import jax_compiled, release_memory  # noqa: F401

# tests/test_gan_engine.py::tiny_models, with a 4-color palette so that
# the render and the path length take the attention branch.
GEN = dict(latent_dim=64, scene_range=0.55, use_sdf=True, w_dim=64, plane_channels=8,
           synthesis_resolution=16, channel_base=512, channel_max=64)
B, RES, NUM_CLASSES = 4, 16, 5
# The render's box, 1e-4 inside the generator's: no sample on the clip kink.
SR_INNER = 0.55 * (1.0 - 1e-4)


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def seeded_variables(module, seed, *args, method=None, noise=False):
    """A flax module's variable tree from its abstract init, with seeded
    values: weights N(0, 1) (N(0, 100) in mapping networks, whose layers
    divide by their lr multiplier 0.01), biases N(0, 0.1) (1 + N(0, 0.1)
    in the style affines), norm scales and beta/alpha 1 + |N(0, 0.1)|,
    noise strengths 0 (with `noise`, 0.1 + |N(0, 0.1)|)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, method=method),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['noise_strength']"):
            v = (0.1 + np.abs(rng.standard_normal(leaf.shape)) * 0.1 if noise
                 else np.zeros(leaf.shape))
        elif name.endswith(("['beta']", "['alpha']")) or "_weight']" in name:
            v = 1.0 + np.abs(rng.standard_normal(leaf.shape)) * 0.1
        elif name.endswith("['bias']") or name.endswith("_bias']"):
            v = rng.standard_normal(leaf.shape) * 0.1
            if "['affine']" in name:
                v = v + 1.0
        else:
            v = rng.standard_normal(leaf.shape)
            if "mapping" in name and name.endswith("['weight']"):
                v = v * 100.0
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def gen_pair(attention_values=4, noise=False, **cond):
    """(JAX generator, its seeded variables, the port's generator with the
    same weights) at GEN's sizes; `cond`: use_encoder or num_classes;
    `noise`: StyleGAN noise strengths that are not 0."""
    jm = JaxGenerator(attention_values=attention_values, **GEN, **cond)
    variables = seeded_variables(jm, 7, method="init_all", noise=noise)
    tm = Generator(attention_values=attention_values, **GEN, **cond, device="cpu")
    tm.load_state_dict(state_dict_from_jax(_np(variables)), strict=True)
    return jm, variables, tm


# The step tests' discriminators: channels <= 32 instead of 512 (the
# modules' own tests hold the 512-channel network). The steps' logic does
# not depend on the width, and a narrow network runs the reference steps
# several times sooner.
NARROW_D = dict(channel_base=512, channel_max=32)


@contextlib.contextmanager
def narrow_discriminators():
    """Both packages' Discriminator builds NARROW_D backbones inside; the
    JAX one reads the patch whenever it is applied."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdisc_mod, "DiscriminatorBackbone",
                   functools.partial(jsg.DiscriminatorBackbone, **NARROW_D))
        mp.setattr(tdisc_mod, "DiscriminatorBackbone",
                   functools.partial(tsg.DiscriminatorBackbone, **NARROW_D))
        yield


@functools.lru_cache(maxsize=None)
def disc_pair(seed=11, narrow=False, **kw):
    """(JAX discriminator, its seeded variables, the port's) at 16^2;
    `narrow`: built under narrow_discriminators (apply the JAX one there
    too)."""
    if narrow:
        with narrow_discriminators():
            return disc_pair(seed, **kw)
    kw = dict(dict(resolution=RES, nc=3, camera_flipped=False, conditional_pose=True), **kw)
    jd = JaxDiscriminator(**kw)
    zeros = jnp.zeros((2, RES, RES, 3))
    label = jnp.zeros((2,), jnp.int32) if kw.get("num_classes") else None
    variables = seeded_variables(jd, seed, zeros, jnp.broadcast_to(jnp.eye(4), (2, 4, 4)),
                                 zeros if kw.get("use_encoder") else None, jnp.ones((2,)),
                                 label)
    td = Discriminator(**kw, device="cpu")
    td.load_state_dict(state_dict_from_jax(_np(variables)), strict=True)
    return jd, variables, td


def random_cameras(rng, bs=B):
    mats = []
    for _ in range(bs):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        m = np.eye(4)
        m[:3, :3] = q
        m[:3, 3] = q @ np.array([0.0, 0.0, 2.5])
        mats.append(m)
    return np.stack(mats).astype(np.float32), (1.0 + rng.random(bs)).astype(np.float32)


def random_batch(rng, with_images=False, classes=False):
    """(port batch, JAX batch) of the same seeded values."""
    pose, focal = random_cameras(rng)
    batch = {"pose": pose, "focal": focal}
    if with_images:
        batch["images"] = (rng.random((B, RES, RES, 3)) * 2 - 1).astype(np.float32)
    if classes:
        batch["classes"] = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
    port = {k: _t(v, torch.long if k == "classes" else torch.float32)
            for k, v in batch.items()}
    return port, {k: jnp.asarray(v) for k, v in batch.items()}


def _transform(gen, p=0.8):
    t = taug.sample_transform(gen, B, p)
    return t, jaug.AugmentTransform(*(jnp.asarray(x.numpy()) for x in t))


def _stratified_bins(gen, n=8):
    """Stratified points of an (n-1)^3 grid from the port's sampler."""
    return tsampling.sample_volume_stratified(gen, B, n, GEN["scene_range"])


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("white", [False, True])
def test_blur_dynamic_and_blur_match_jax(white):
    x = np.random.default_rng(0).random((2, 24, 24, 3)).astype(np.float32) * 2 - 1
    jblur = jax.jit(lambda xx, s: jfilters.blur_dynamic(xx, s, white))
    for sigma in (0.0, 0.3, 2.5, 10.0):
        want = np.asarray(jblur(jnp.asarray(x), jnp.float32(sigma)))
        got = tfilters.blur_dynamic(_t(x), sigma, white)
        assert _rel(got, want) < 1e-6, sigma
        if sigma == 0.0:
            assert torch.equal(got, _t(x))
        # Away from a kernel-size boundary the JAX package's static blur
        # (f64 taps through filt2d_same) takes the same taps.
        assert _rel(got, np.asarray(jfilters.blur(jnp.asarray(x), sigma, white))) < 1e-6
    for it in (0, 6250, 12499, 12500, 20000):
        assert tfilters.blur_schedule_sigma(it, 12500) == float(
            jfilters.blur_schedule_sigma(jnp.int32(it), 12500))


@pytest.mark.parametrize("transpose", [False, True])
def test_conv_backward_computes_only_the_used_gradients(transpose, monkeypatch):
    """ops/conv.py against torch's own convolution: the first derivatives
    and a second one (the gradient of a penalty on the input gradient, as
    R1 takes it) agree, and a pass that needs only the input gradient
    (R1's inner gradient, a G step through D) takes no weight gradient."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 9, 9), generator=gen, requires_grad=True)
    w = torch.randn((3, 4, 3, 3) if transpose else (4, 3, 3, 3), generator=gen,
                    requires_grad=True)
    ours = conv_ops.conv_transpose2d if transpose else conv_ops.conv2d
    native = F.conv_transpose2d if transpose else F.conv2d
    weight_grads = []
    real = conv_ops._weight_grad
    monkeypatch.setattr(conv_ops, "_weight_grad",
                        lambda *a: weight_grads.append(1) or real(*a))
    r = None
    results = []
    for conv in (ours, native):
        y = conv(x, w * 0.5, stride=2, padding=1)
        r = torch.randn(y.shape, generator=gen) if r is None else r
        (gx,) = torch.autograd.grad(torch.sum(y * r), x, create_graph=True)
        if conv is ours:
            assert not weight_grads
        (gw,) = torch.autograd.grad(torch.sum(y * r), w, retain_graph=True)
        if conv is ours:
            assert len(weight_grads) == 1
        results.append((y, gx, gw, *torch.autograd.grad(torch.sum(gx**2), w)))
    for a, b in zip(*results):
        assert _rel(a, b.detach().numpy()) < 1e-5


def test_sample_volume_stratified_matches_jax_exactly(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    jitter = torch.rand((3, 7**3, 3), generator=gen)
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(jitter.numpy()))
    want = np.asarray(jsampling.sample_volume_stratified(jax.random.key(0), 3, 8, 0.55))
    got = tsampling.sample_volume_stratified(None, 3, 8, 0.55, jitter=jitter)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- models


def test_minibatch_std_matches_jax():
    x = np.random.default_rng(1).standard_normal((8, 6, 4, 4)).astype(np.float32)
    for group, channels in ((4, 1), (2, 2), (16, 1)):
        want = jax.jit(jsg.minibatch_std, static_argnums=(1, 2))(
            jnp.asarray(x.transpose(0, 2, 3, 1)), group, channels)
        got = tsg.minibatch_std(_t(x), group, channels)
        assert _rel(got.permute(0, 2, 3, 1), want) < 1e-6, (group, channels)


@pytest.mark.parametrize("kind", ["unconditional", "pose", "class", "encoder"])
def test_discriminator_logits_match_jax(kind):
    kw = {"unconditional": dict(conditional_pose=False), "pose": {},
          "class": dict(num_classes=NUM_CLASSES), "encoder": dict(use_encoder=True)}[kind]
    jd, variables, td = disc_pair(**kw)
    rng = np.random.default_rng(2)
    pb, jb = random_batch(rng, with_images=True, classes=kind == "class")
    cond = pb["images"] if kind == "encoder" else None
    jcond = jb["images"] if kind == "encoder" else None
    want = jax.jit(lambda v, b, c: jd.apply(v, b["images"], b["pose"], c, b["focal"],
                                            b.get("classes")))(variables, jb, jcond)
    got = td(pb["images"], pb["pose"], cond, pb["focal"], pb.get("classes"))
    assert got.shape == (B, 1)
    assert _rel(got, want) < 1e-5


def _min_abs_activation(module, *inputs):
    """The smallest |output| of any activated layer in a forward pass."""
    mins = []
    hooks = [m.register_forward_hook(lambda m, i, o: mins.append(float(o.abs().min())))
             for m in module.modules() if getattr(m, "activate", False)]
    with torch.no_grad():
        module(*inputs)
    for h in hooks:
        h.remove()
    return min(mins)


def test_discriminator_parameter_gradients_match_jax():
    """The batch is one whose activations all stay 5e-7 away from the
    leaky ReLU's kink: nearer, one ulp of f32 rounding can put a
    pre-activation on the other side in one package (slope 1 against 0.2),
    which changes the earlier layers' gradients by ~1e-3 in f32 while
    both agree with float64 elsewhere."""
    jd, variables, td = disc_pair()
    pb, jb = random_batch(np.random.default_rng(208), with_images=True)
    assert _min_abs_activation(td, pb["images"], pb["pose"], None, pb["focal"]) > 5e-7
    w = np.random.default_rng(4).standard_normal((B, 1)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jd.apply({"params": p}, jb["images"], jb["pose"], None,
                                jb["focal"]) * w)

    want = state_dict_from_jax(
        {"params": _np(jax.jit(jax.grad(jloss))(variables["params"]))})
    loss = torch.sum(td(pb["images"], pb["pose"], None, pb["focal"]) * _t(w))
    names, params_t = zip(*td.named_parameters())
    grads = torch.autograd.grad(loss, params_t)
    assert set(names) == set(want)
    errs = {name: _rel(g, want[name]) for name, g in zip(names, grads)}
    assert max(errs.values()) < 1e-4, errs


def test_residual_encoder_and_conditional_mapping_match_jax():
    rng = np.random.default_rng(5)
    img = (rng.random((B, RES, RES, 3)) * 2 - 1).astype(np.float32)
    z = rng.standard_normal((B, GEN["latent_dim"])).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, B)

    enc = JaxResidualEncoder(3, 256)
    params = seeded_variables(enc, 6, jnp.zeros((1, RES, RES, 3)))
    tenc = ResidualEncoder(3, 256)
    tenc.load_state_dict(state_dict_from_jax(_np(params)), strict=True)
    assert _rel(tenc(_t(img)), jax.jit(enc.apply)(params, jnp.asarray(img))) < 1e-5

    jm, variables, tm = gen_pair(use_encoder=True)
    want = jax.jit(lambda v, z, i: jm.apply(v, z, None, i, method="mapping"))(
        variables, jnp.asarray(z), jnp.asarray(img))
    assert "emb.norm3.weight" in tm.state_dict()
    assert _rel(tm.mapping(_t(z), image=_t(img)), want) < 1e-5

    jm, variables, tm = gen_pair(num_classes=NUM_CLASSES)
    want = jax.jit(lambda v, z, c: jm.apply(v, z, c, method="mapping"))(
        variables, jnp.asarray(z), jnp.asarray(label))
    assert _rel(tm.mapping(_t(z), torch.tensor(label)), want) < 1e-5
    with pytest.raises(ValueError, match="label"):
        tm.mapping(_t(z))
    # average_w per label: the mapping of the same latents, averaged.
    gen = torch.Generator().manual_seed(0)
    w = tm.average_w(gen, n_samples=8, label=torch.tensor(label))
    assert w.shape == (B, tm.num_ws, GEN["w_dim"])


def _planes(variables, jm, seed=8):
    ws = np.random.default_rng(seed).standard_normal((B, jm.num_ws, GEN["w_dim"]))
    ws = jnp.asarray(ws.astype(np.float32))
    return ws, jax.jit(lambda v, w: jm.apply(v, w, method="synthesize"))(variables, ws)


def test_raw_plane_decode_and_its_second_derivative_match_jax():
    """The grid-sample decode of raw planes, and the gradient of an
    eikonal term (a function of d distance / d points) with respect to the
    decoder's parameters: a second derivative through the sampler."""
    jm, variables, tm = gen_pair()
    _, planes = _planes(variables, jm)
    pts = _stratified_bins(torch.Generator().manual_seed(9)) / GEN["scene_range"]

    def jeik(dec_params, pts):
        v = {**variables, "params": {**variables["params"], "decoder": dec_params}}

        def dist(p):
            return jm.apply(v, planes, p, method="decode")[0][..., -1]

        d, vjp = jax.vjp(dist, pts)
        (g,) = vjp(jnp.ones_like(d))
        return jnp.mean(jnp.square(jnp.linalg.norm(g, axis=-1) - 1.0)), d

    args = (variables["params"]["decoder"], jnp.asarray(pts.numpy()))
    (jval, jd), jgrad = jax_compiled(jax.value_and_grad(jeik, has_aux=True), *args)(*args)
    tplanes = _t(planes)
    x = pts.clone().requires_grad_(True)
    d, feats = tm.decode(tplanes, x)
    assert _rel(d[..., -1], jd) < 1e-4
    (g,) = torch.autograd.grad(d[..., -1].sum(), x, create_graph=True)
    val = torch.mean(torch.square(torch.linalg.vector_norm(g, dim=-1) - 1.0))
    assert _rel(val, jval) < 1e-4
    names, params = zip(*tm.decoder.named_parameters())
    grads = dict(zip(names, tgan.param_grads(val, list(params))))
    want = state_dict_from_jax({"params": {"decoder": _np(jgrad)}})
    for name, g in grads.items():
        assert _rel(g, want["decoder." + name]) < 1e-4, name


@contextlib.contextmanager
def jax_draws(normals=None, tforms=(), bins=None, identity_optimizer=False):
    """Patches the JAX package's draws for a trace (see the module
    docstring): normals {shape: array, or a list of them drawn in call
    order}, transforms in call order, the stratified points; with
    identity_optimizer, the step functions return their gradients as
    parameters. The renders are deterministic (a key reaches only the
    StyleGAN noise)."""
    queue = list(tforms)

    normals = {k: list(v) if isinstance(v, list) else v for k, v in (normals or {}).items()}
    real_normal, real_render_field = jax.random.normal, jrender.render_field

    def normal(key, shape=(), dtype=jnp.float32):
        # Other shapes are flax's initializers, which it evaluates
        # abstractly to check the given parameters' shapes. A list is
        # drawn from in call order (StyleGAN noise: two layers a block).
        value = normals.get(tuple(shape))
        if value is None:
            return real_normal(key, shape, dtype)
        return jnp.asarray(value.pop(0) if isinstance(value, list) else value, dtype)

    def render(*a, key=None, **k):
        # A key for StyleGAN noise alone: the field's samples stay fixed.
        return jrender.render(*a, key=jax.random.key(0) if k.get("noise_mode") == "random"
                              else None, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgan, "render", render)
        mp.setattr(jrender, "render_field",
                   lambda *a, key=None, **k: real_render_field(*a, key=None, **k))
        if normals:
            mp.setattr(jax.random, "normal", normal)
        mp.setattr(jaug, "sample_transform", lambda *a, **k: queue.pop(0))
        if bins is not None:
            mp.setattr(jreg, "sample_volume_stratified", lambda *a, **k: jnp.asarray(bins))
        if identity_optimizer:
            ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                                 lambda u, s, p=None: (u, s))
            mp.setattr(jgan, "make_optimizers", lambda config: (ident, ident))
            mp.setattr(optax, "apply_updates", lambda p, u: u)
            mp.setattr(jgan, "_clamp_sdf_params", lambda p, use_sdf: p)
        yield
    assert not queue, "not every transform was drawn"
    assert not any(v for v in normals.values() if isinstance(v, list)), "a noise was not drawn"


def _param_grads(module, params_list, grads):
    names = dict((id(p), n) for n, p in module.named_parameters())
    return {names[id(p)]: g for p, g in zip(params_list, grads)}


def test_path_length_and_volume_regularizers_match_jax():
    jm, variables, tm = gen_pair()
    ws, planes = _planes(variables, jm, seed=10)
    gen = torch.Generator().manual_seed(11)
    noise_p, noise_a = treg.path_length_noise(tm, tuple(planes.shape), gen, "cpu")
    bins = _stratified_bins(gen)
    perturb = torch.randn(bins.shape, generator=gen)
    normals = {tuple(noise_p.shape): noise_p.numpy() * np.sqrt(RES * RES),
               tuple(noise_a.shape): noise_a.numpy(), tuple(bins.shape): perturb.numpy()}

    def jlosses(params):
        v = {**variables, "params": params}
        ppl = jreg.path_length(jm, v, ws, jax.random.key(0))
        planes_ = jm.apply(v, ws, method="synthesize")
        regs = jreg.volume_regularizers(jm, v, planes_, jax.random.key(1))
        return jnp.sum(ppl) + sum(jnp.sum(r) for r in regs.values()), (ppl, regs)

    with jax_draws(normals, bins=bins.numpy()):
        (_, (jppl, jregs)), jgrads = jax_compiled(
            jax.value_and_grad(jlosses, has_aux=True), variables["params"])(variables["params"])
    want = state_dict_from_jax({"params": _np(jgrads)})

    tws = _t(ws)
    ppl = treg.path_length(tm, tws, (noise_p, noise_a))
    regs = treg.volume_regularizers(tm, tm.synthesize(tws), bins, perturb)
    assert _rel(ppl, jppl) < 1e-4
    assert set(regs) == set(jregs) == {"sdf_eikonal_loss", "total_variation_loss",
                                       "entropy_loss"}
    for k in regs:
        assert _rel(regs[k], jregs[k]) < 1e-4, k
    loss = torch.sum(ppl) + sum(torch.sum(r) for r in regs.values())
    params = list(tm.parameters())
    grads = _param_grads(tm, params, tgan.param_grads(loss, params))
    for name, g in grads.items():
        assert _rel(g, want[name]) < 1e-4, name


# ------------------------------------------------------- optimizer, EMA


def test_optimizer_matches_optax_on_shared_gradients():
    """Clip (triggered at the second step), Adam b1 = 0 and the
    count-based learning rate over three updates on the same gradients."""
    config = jgan.GANTrainConfig(clip_gradient_norm=1.0, lr_warmup_iters=4)
    tx_g, _ = jgan.make_optimizers(config)
    rng = np.random.default_rng(12)
    shapes = {"a": (3, 4), "b": (5,)}
    jparams = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
               for k, s in shapes.items()}
    tparams = [torch.nn.Parameter(_t(jparams[k])) for k in shapes]
    opt = tgan.make_optimizer(tparams, tgan.GANTrainConfig(clip_gradient_norm=1.0,
                                                           lr_warmup_iters=4), 0.0025)
    jstate = tx_g.init(jparams)
    for scale in (0.1, 3.0, 0.5):
        grads = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32) * scale)
                 for k, s in shapes.items()}
        updates, jstate = tx_g.update(grads, jstate, jparams)
        # From zero parameters the step leaves the update itself (Adam
        # does not read the parameters).
        with torch.no_grad():
            for p in tparams:
                p.zero_()
        opt.step([_t(grads[k]) for k in shapes])
        for k, p in zip(shapes, tparams):
            assert _rel(p, updates[k]) < 1e-6, (scale, k)
        assert opt.count == int(jstate[1].count)


def test_ema_matches_jax_exactly():
    rng = np.random.default_rng(13)
    ema, model = torch.nn.Linear(5, 3), torch.nn.Linear(5, 3)
    jema = {}
    for name, p in ema.named_parameters():
        p.data = _t(rng.standard_normal(p.shape).astype(np.float32))
        jema[name] = jnp.asarray(p.detach().numpy())
    for it in (0, 999, 1000, 9999, 10000, 30000):
        jparams = {}
        for name, p in model.named_parameters():
            p.data = _t(rng.standard_normal(p.shape).astype(np.float32))
            jparams[name] = jnp.asarray(p.detach().numpy())
        jema = jgan.update_ema(jema, jparams, jnp.int32(it))
        tgan.update_ema(ema, model, it)
        for name, p in ema.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jema[name]))


def test_sdf_pretrain_step_loss_matches_jax():
    jm, variables, tm = gen_pair()
    config = tgan.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"])
    gen = torch.Generator().manual_seed(14)
    z = torch.randn((B, GEN["latent_dim"]), generator=gen)
    bins = _stratified_bins(gen)
    ws = jax.jit(lambda v, z: jm.apply(v, z, method="mapping"))(variables, jnp.asarray(z.numpy()))
    with jax_draws(bins=bins.numpy()):
        losses = jax.jit(lambda v, w: jreg.sdf_pretrain_losses(jm, v, w, jax.random.key(0)))(
            variables, ws)
    want = jnp.mean(losses["sdf_distance_loss"]) + 0.1 * jnp.mean(losses["sdf_eikonal_loss"])
    model = Generator(attention_values=4, **GEN, device="cpu")
    model.load_state_dict(tm.state_dict())
    opt = tgan.make_pretrain_optimizer(model, 0.0025)
    loss = tgan.sdf_pretrain_step(config, model, opt, draws={"z": z, "bins": bins})
    assert _rel(loss, want) < 1e-4
    assert opt.count == 1
    moved = [not torch.equal(a, b) for a, b in zip(model.parameters(), tm.parameters())]
    assert any(moved)


# ------------------------------------------------------------- G and D steps


def _render_configs(**kw):
    common = dict(resolution=RES, depth_samples_per_ray=8, fine_sampling=True,
                  scene_range=SR_INNER, white_background=True)
    return jrender.RenderConfig(query_chunk=None, **common), RenderConfig(**common, **kw)


def _jax_state(config, rc, jm, variables, jd, dparams, jd2=None, d2params=None, **fields):
    shapes = jax.eval_shape(lambda k: jgan.init_gan_state(config, jm, jd, k, rc, disc2=jd2),
                            jax.random.key(0))
    state = jax.tree.map(lambda l: jnp.zeros(l.shape, l.dtype), shapes)
    return state._replace(params_g=variables["params"], params_ema=variables["params"],
                          buffers_g=variables["buffers"], params_d=dparams,
                          params_d2=d2params, **fields)


def _recording_optimizer(monkeypatch):
    recorded = []
    original = tgan.Optimizer.step

    def step(self, grads):
        recorded.append((self.params, [g.clone() for g in grads]))
        return original(self, grads)

    monkeypatch.setattr(tgan.Optimizer, "step", step)
    return recorded


G_ITERATION = 4000  # path length, TV and entropy weighted; blur sigma 6.8; EMA decay alpha^10

# The G steps held to JAX: the README's unconditional trainer; dual mode
# with class labels and StyleGAN noise (the second render, from an
# augmented second camera, to the second discriminator); dual L1 with an
# encoder-conditioned generator (the conditional discriminator replaced
# by the L1 distance to the blurred conditioning image).
G_CASES = {
    "unconditional": dict(),
    "dual_class_noise": dict(use_class=True, dual_discriminator=True, noise_mode="random"),
    "dual_l1_encoder": dict(use_encoder=True, dual_discriminator=True, dual_l1=True),
}


def _g_models(kind):
    """(generator pair, discriminator pair or None, second discriminator
    pair or None) of a G_CASES entry."""
    fields = G_CASES[kind]
    cond = (dict(num_classes=NUM_CLASSES) if fields.get("use_class")
            else dict(use_encoder=True) if fields.get("use_encoder") else {})
    gen = gen_pair(noise=fields.get("noise_mode") == "random", **cond)
    disc = None if fields.get("dual_l1") else disc_pair(
        narrow=True, **({"num_classes": NUM_CLASSES} if fields.get("use_class") else {}))
    disc2 = disc_pair(seed=12, narrow=True) if fields.get("dual_discriminator") else None
    return gen, disc, disc2


def _g_config(package, kind):
    return package.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"],
                                  white_background=True, augment_p=0.5,
                                  path_length_regularization=True, **G_CASES[kind])


def _noise_resolutions(model):
    """The resolutions of the synthesis layers that draw StyleGAN noise,
    in call order."""
    return [m.resolution for m in model.synthesis_network.modules()
            if isinstance(m, tsg.SynthesisLayer) and m.use_noise]


@pytest.fixture(scope="module", params=list(G_CASES))
def g_case(request):
    """One G step of the JAX package of the G_CASES entry (each with
    fixed-p camera augmentation and path length): its metrics, gradients
    and path-length average, and the draws it was given."""
    kind = request.param
    fields = G_CASES[kind]
    (jm, variables, tm), disc, disc2 = _g_models(kind)
    jd, dparams = (disc[0], disc[1]["params"]) if disc else (None, None)
    jd2, d2params = (disc2[0], disc2[1]["params"]) if disc2 else (None, None)
    config = _g_config(jgan, kind)
    jrc, _ = _render_configs()
    rng = np.random.default_rng(15)
    pb, jb = random_batch(rng, with_images=fields.get("use_encoder", False),
                          classes=fields.get("use_class", False))
    pb2, jb2 = random_batch(rng) if disc2 else (None, None)
    gen = torch.Generator().manual_seed(16)
    # The dual L1 branch compares the render with the conditioning image
    # itself: its first camera is not augmented.
    ttform, jtform = _transform(gen) if not fields.get("dual_l1") else (None, None)
    ttform2, jtform2 = _transform(gen) if disc2 else (None, None)
    z = torch.randn((B, GEN["latent_dim"]), generator=gen)
    bins = _stratified_bins(gen)
    perturb = torch.randn(bins.shape, generator=gen)
    planes_shape = (B, 3, RES, RES, GEN["plane_channels"])
    noise_p, noise_a = treg.path_length_noise(tm, planes_shape, gen, "cpu")
    normals = {(B, GEN["latent_dim"]): z.numpy(), tuple(bins.shape): perturb.numpy(),
               planes_shape: noise_p.numpy() * np.sqrt(RES * RES),
               tuple(noise_a.shape): noise_a.numpy()}
    noise = []
    if fields.get("noise_mode") == "random":
        # Each render's layers in call order, NHWC as the JAX package draws.
        noise = [torch.randn((B, r, r, 1), generator=gen)
                 for _ in range(2) for r in _noise_resolutions(tm)]
        for n in noise:
            normals.setdefault(tuple(n.shape), []).append(n.numpy())
    state = _jax_state(config, jrc, jm, variables, jd, dparams, jd2, d2params,
                       iteration=jnp.int32(G_ITERATION), ppl_running_avg=-jnp.ones(()),
                       augment_p_eff=jnp.float32(0.5))
    tforms = [t for t in (jtform, jtform2) if t is not None]
    with narrow_discriminators(), jax_draws(normals, tforms, bins.numpy(),
                                            identity_optimizer=True):
        new_state, metrics = jax_compiled(
            lambda s, b, b2: jgan.g_step(config, jrc, jm, jd, s, b, jax.random.key(1),
                                         disc2=jd2, batch2=b2),
            state, jb, jb2)(state, jb, jb2)
    draws = {"z": z, "tform": ttform, "tform2": ttform2, "bins": bins, "perturb": perturb,
             "ppl_noise": (noise_p, noise_a)}
    return (kind, pb, pb2, draws, noise, {k: float(v) for k, v in metrics.items()},
            state_dict_from_jax({"params": _np(new_state.params_g)}),
            float(new_state.ppl_running_avg))


def test_g_step_matches_jax(g_case, monkeypatch):
    kind, pb, pb2, draws, noise, jmetrics, jgrads, jppl = g_case
    (_, _, tm0), disc, disc2 = _g_models(kind)
    discs = [d[2] for d in (disc, disc2) if d]
    model = copy.deepcopy(tm0)
    config = _g_config(tgan, kind)
    _, rc = _render_configs()
    state = tgan.init_gan_state(config, model, disc[2] if disc else None,
                                disc2[2] if disc2 else None)
    state.iteration = G_ITERATION
    state.augment_p_eff.fill_(0.5)
    d_before = [[p.detach().clone() for p in d.parameters()] for d in discs]
    queue = [n.permute(0, 3, 1, 2) for n in noise]
    monkeypatch.setattr(tsg, "_noise", lambda generator, shape, like: queue.pop(0))
    recorded = _recording_optimizer(monkeypatch)
    metrics = tgan.g_step(config, rc, state, pb, None, pb2, draws=draws)
    assert not queue

    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        assert abs(float(v) - jmetrics[k]) <= 1e-4 * abs(jmetrics[k]), (k, float(v), jmetrics[k])
    assert abs(float(state.ppl_running_avg) - jppl) <= 1e-4 * abs(jppl)
    ((params, grads),) = recorded
    grads = _param_grads(model, params, grads)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert _rel(g, jgrads[name]) < 1e-4, name
    if noise:
        assert float(torch.linalg.vector_norm(
            grads["synthesis_network.b16.conv1.noise_strength"])) > 0
    # The step moved G and its EMA, and left the discriminators and every
    # .grad untouched.
    assert state.iteration == G_ITERATION + 1 and state.opt_g.count == 1
    assert not torch.equal(model.synthesis_network.b16.conv1.weight,
                           tm0.synthesis_network.b16.conv1.weight)
    assert not torch.equal(state.ema.decoder.net[0].weight, tm0.decoder.net[0].weight)
    for d, before in zip(discs, d_before):
        assert all(torch.equal(a, b) for a, b in zip(before, d.parameters()))
    params = [p for d in discs for p in d.parameters()] + list(model.parameters())
    assert all(p.grad is None for p in params)


D_ITERATIONS = (7, 12503)  # ADA updates at both; the first is in the blur warm-up


@pytest.fixture(scope="module")
def d_case():
    """D steps of the JAX package in dual mode with class labels, ADA and
    augmentation, at D_ITERATIONS: one trace, called twice."""
    jm, variables, _ = gen_pair(num_classes=NUM_CLASSES)
    jd, dvars, _ = disc_pair(narrow=True, num_classes=NUM_CLASSES)
    jd2, d2vars, _ = disc_pair(seed=12, narrow=True)
    dparams, d2params = dvars["params"], d2vars["params"]
    config = jgan.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"],
                                 white_background=True, augment_p=0.8, augment_ada=True,
                                 use_class=True, dual_discriminator=True)
    jrc, _ = _render_configs()
    rng = np.random.default_rng(17)
    batches = [random_batch(rng, with_images=w, classes=True) for w in (True, False, True, False)]
    gen = torch.Generator().manual_seed(18)
    tforms = [_transform(gen) for _ in range(4)]
    z = torch.randn((B, GEN["latent_dim"]), generator=gen)
    def d_step(s, rb, fb, rb2, fb2):
        return jgan.d_step(config, jrc, jm, jd, s, rb, fb, jax.random.key(2), disc2=jd2,
                           real_batch2=rb2, fake_batch2=fb2)

    out, step = [], None
    with narrow_discriminators(), jax_draws({(B, GEN["latent_dim"]): z.numpy()},
                                            [t[1] for t in tforms], identity_optimizer=True):
        for it in D_ITERATIONS:
            state = _jax_state(config, jrc, jm, variables, jd, dparams, jd2, d2params,
                               iteration=jnp.int32(it), ppl_running_avg=-jnp.ones(()),
                               augment_p_eff=jnp.float32(0.3))
            args = (state,) + tuple(b[1] for b in batches)
            step = step or jax_compiled(d_step, *args)
            new_state, metrics = step(*args)
            out.append(({k: float(v) for k, v in metrics.items()},
                        state_dict_from_jax({"params": _np(new_state.params_d)}),
                        state_dict_from_jax({"params": _np(new_state.params_d2)}),
                        float(new_state.augment_p_eff)))
    draws = {"z": z, "tform_real": tforms[0][0], "tform_fake": tforms[1][0],
             "tform_real2": tforms[2][0], "tform_fake2": tforms[3][0]}
    return [b[0] for b in batches], draws, out


def test_d_step_matches_jax(d_case, monkeypatch):
    """R1 of both discriminators, their joint clip, and ADA's p: held at 0
    in the blur warm-up, moved by batch * interval / rampup after it,
    exactly."""
    batches, draws, out = d_case
    _, _, tm = gen_pair(num_classes=NUM_CLASSES)
    config = tgan.GANTrainConfig(batch_size=B, latent_dim=GEN["latent_dim"],
                                 white_background=True, augment_p=0.8, augment_ada=True,
                                 use_class=True, dual_discriminator=True)
    _, rc = _render_configs()
    for it, (jmetrics, jgrads, jgrads2, jp) in zip(D_ITERATIONS, out):
        _, _, td0 = disc_pair(narrow=True, num_classes=NUM_CLASSES)
        _, _, td20 = disc_pair(seed=12, narrow=True)
        td, td2 = copy.deepcopy(td0), copy.deepcopy(td20)
        state = tgan.init_gan_state(config, tm, td, td2)
        state.iteration = it
        state.augment_p_eff.fill_(0.3)
        g_before = [p.detach().clone() for p in tm.parameters()]
        recorded = _recording_optimizer(monkeypatch)
        real, fake, real2, fake2 = batches
        metrics = tgan.d_step(config, rc, state, real, fake, None, real2, fake2, draws=draws)
        monkeypatch.undo()
        assert all(torch.equal(a, b) for a, b in zip(g_before, tm.parameters()))
        assert state.iteration == it + 1 and state.opt_d.count == state.opt_d2.count == 1
        assert set(metrics) == set(jmetrics)
        for k, v in metrics.items():
            assert abs(float(v) - jmetrics[k]) <= 1e-4 * abs(jmetrics[k]), (it, k)
        assert float(state.augment_p_eff) == jp == float(metrics["augment_p"])
        assert (jp == 0.0) == (it < config.blur_warmup_iters)
        (p1, g1), (p2, g2) = recorded
        for module, params, grads, want in ((td, p1, g1, jgrads), (td2, p2, g2, jgrads2)):
            grads = _param_grads(module, params, grads)
            assert set(grads) == set(want)
            for name, g in grads.items():
                assert _rel(g, want[name]) < 1e-4, (it, name)
