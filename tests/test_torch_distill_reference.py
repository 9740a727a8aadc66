"""The port's distillation step (engine/coord_regressor.py::coord_train_step)
against the benchmark's plain reference of it
(port_bench/reference/engine/coord_regressor.py) on the CPU, and the
step's profiler ranges.

Tiny widths on seeded random weights: tests/test_torch_gan.py's
generator sizes and a one-block-a-stage MiT encoder (as in
tests/test_torch_encoder.py), 32^2 rays with 8 + 8 samples, B=2, the
cameras of the benchmark's traffic generator. The reference builds each
module from the seed and the port takes its weights through
load_state_dict, as the benchmark hands them over. Each step of both
sides takes its z, render samples and drop-path masks from a generator
seeded by the step. Compared: the first step's targets, every step's
losses, every encoder gradient as the optimizer got it, and the weights
after 2 steps on each side of lr_drop_at. Port-only otherwise: no JAX.
"""

import dataclasses
import functools
import math
import os
import types

import pytest
import torch

from nerf_from_image_tpu_torch.engine import coord_regressor as tcr
from nerf_from_image_tpu_torch.engine.render import RenderConfig
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from port_bench import harness, traffic
from port_bench import trace as bench_trace
from port_bench.reference.engine import coord_regressor as rcr
from port_bench.reference.engine import render as rrender
from port_bench.reference.models import encoder as renc
from port_bench.reference.models import generator as rgen
from tests.test_torch_gan import GEN, SR_INNER
from tests.test_torch_generator import built_once, release_memory  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
B, RES, SAMPLES, DEPTHS = 2, 32, 8, (1, 1, 1, 1)
STEPS, DROP_AT = 4, 2
RANGES = ("distill.targets", "distill.encoder", "distill.optimizer")
# Tolerances, each relative to the largest value of its tensor. Both sides
# run the same operations in the same order on one thread (the reference
# is the port's code frozen before its ranges), so every number agrees to
# the bit today; the tolerances leave room for a reordered sum in the
# port (a few f32 ulps, amplified through the encoder's 4 blocks and two
# 512-channel convolutions), and stay far under what a wrong step gives
# (the planted faults of port_bench read 0.3 to 1).
TARGET_TOL = 1e-6  # no-grad render: one pass of f32 rounding
LOSS_TOL = 1e-6  # means of the targets' and predictions' gaps
GRAD_TOL = 1e-5  # the backward through the encoder: rounding grows by depth
# Adam moves each weight by about lr x sign(gradient), so a gradient entry
# that is rounding on both sides may take either sign: the gap of a
# weight is then up to 2 lr per step, a share of the leaf's largest
# weight of at most ~1e-4 at lr 6e-5; a wrong update moves whole leaves.
WEIGHT_TOL = 1e-4


def _seeded(seed):
    return torch.Generator().manual_seed(seed)


def _pair(make):
    """(reference module, port module with its weights)."""
    ref = make(True, _seeded(1))
    port = make(False, _seeded(2))
    port.load_state_dict(ref.state_dict())
    return ref, port


def _generator(ref, gen):
    cls = rgen.Generator if ref else Generator
    return cls(attention_values=4, **GEN, device="cpu", generator=gen).requires_grad_(False)


def _encoder(ref, gen):
    cls = renc.BootstrapEncoder if ref else BootstrapEncoder
    return cls(GEN["w_dim"], backbone_depths=DEPTHS, device="cpu", generator=gen)


@functools.lru_cache(maxsize=1)
def _start():
    """The weights both sides start from and the cameras of every step."""
    gens = _pair(_generator)
    encs = _pair(_encoder)
    cams = traffic.cameras(_seeded(3), B * STEPS, {"distance": [1.2, 1.6],
                                                   "elevation": [-0.4, 0.4],
                                                   "focal": [1.0, 2.0]}, CPU)
    return gens, {k: v.clone() for k, v in encs[0].state_dict().items()}, cams


def _run(side, steps=STEPS):
    """`steps` steps of one side ('port' or 'reference') from the shared
    start: (targets of step 0, losses of each step, the gradients each
    step's optimizer got, the weights after each step)."""
    ref = side == "reference"
    cr = rcr if ref else tcr
    (rgen_, pgen), state, cams = _start()
    model = rgen_ if ref else pgen
    encoder = _encoder(ref, _seeded(4))
    encoder.load_state_dict(state)
    config = cr.CoordRegressorConfig(latent_dim=GEN["latent_dim"], max_iters=2 * DROP_AT,
                                     lr_drop_at=DROP_AT)
    rc_cls = rrender.RenderConfig if ref else RenderConfig
    rc = rc_cls(resolution=RES, depth_samples_per_ray=SAMPLES, scene_range=SR_INNER)
    opt = cr.make_optimizer(config, encoder)
    grads = []
    step = opt.step
    opt.step = lambda g: (grads.append([t.clone() for t in g]), step(g))
    out = {"losses": [], "grads": grads, "weights": []}
    for i in range(steps):
        batch = {"pose": cams["pose"][B * i:B * (i + 1)], "focal": cams["focal"][B * i:B * (i + 1)]}
        if i == 0:
            g = _seeded(100)
            z = torch.randn((B, config.latent_dim), generator=g)
            out["targets"] = cr.render_targets(rc, model, batch, z, g, CPU)
        losses = cr.coord_train_step(config, rc, model, encoder, opt, batch, _seeded(100 + i),
                                     device=CPU)
        out["losses"].append(losses)
        out["weights"].append([p.detach().clone() for p in encoder.parameters()])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' runs, made once a session and shared by the workers."""
    return built_once(tmp_path_factory, "distill_reference_runs",
                      lambda root: {side: _run(side) for side in ("port", "reference")})


def _rel(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else float(got.abs().max())


def test_targets_match_the_reference(runs):
    got, want = runs["port"]["targets"], runs["reference"]["targets"]
    names = ("image", "mask", "coords", "w")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and float(b.abs().max()) > 0, name
        assert _rel(a, b) <= TARGET_TOL, (name, _rel(a, b))
    # The targets are no degenerate frame: the object covers part of it.
    mask = want[1]
    assert 0.05 < float(mask.mean()) < 0.95


def test_losses_match_the_reference_at_every_step(runs):
    got, want = runs["port"]["losses"], runs["reference"]["losses"]
    assert len(got) == len(want) == STEPS
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"loss", "loss_coords", "loss_mask", "loss_latent"}
        for k in b:
            assert math.isfinite(float(b[k]))
            assert _rel(a[k], b[k]) <= LOSS_TOL, (k, float(a[k]), float(b[k]))


def test_every_encoder_gradient_matches_the_reference(runs):
    got, want = runs["port"]["grads"], runs["reference"]["grads"]
    assert len(got) == len(want) == STEPS
    for step, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b)
        moving = [torch.count_nonzero(t) for t in b]
        assert sum(int(n) for n in moving) > 0.5 * sum(t.numel() for t in b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert _rel(x, y) <= GRAD_TOL, (step, i, _rel(x, y))


def test_weights_match_across_the_rate_drop(runs):
    """After 2 steps at lr and 2 at lr / 10 (lr_drop_at = 2), and the
    drop itself: the last two steps move each weight a tenth as far."""
    got, want = runs["port"]["weights"], runs["reference"]["weights"]
    for step in (DROP_AT - 1, STEPS - 1):
        for x, y in zip(got[step], want[step]):
            assert _rel(x, y) <= WEIGHT_TOL, (step, _rel(x, y))
    w = want
    before_drop = max(float((a - b).abs().max()) for a, b in zip(w[1], w[0]))
    after_drop = max(float((a - b).abs().max()) for a, b in zip(w[3], w[2]))
    assert after_drop == pytest.approx(before_drop / 10, rel=0.05)


def _one_step():
    return _run("port", steps=1)


def test_the_step_names_its_phases_and_the_readers_read_them(monkeypatch):
    made = []
    summary = bench_trace.profile(lambda: made.append(_one_step()), CPU)
    names = {n for _, _, n in summary.spans}
    assert set(RANGES) <= names and "gan.backward" in names
    assert {"render.synthesis", "render.coarse", "render.fine"} <= names
    spans = {n: (a, b) for a, b, n in summary.spans if n in RANGES + ("gan.backward",)}
    # In the step's order, one after another.
    order = sorted(spans, key=lambda n: spans[n][0])
    assert order == ["distill.targets", "distill.encoder", "gan.backward", "distill.optimizer"]
    for name, reader in (("distill.encoder", "encoder_ms.distill"),
                         ("distill.optimizer", "encoder_update_ms.distill"),
                         ("gan.backward", "backward_ms.distill"),
                         ("render", "render_ms.distill")):
        read = harness.metric_reader(ROOT, reader).read
        value = read(types.SimpleNamespace(trace=summary, steps_per_unit=1))
        assert math.isfinite(value) and 0 < value <= (summary.window[1] - summary.window[0]) * 1e-3
        bare = dataclasses.replace(summary, spans=[s for s in summary.spans
                                                   if not s[2].startswith(name)])
        assert read(types.SimpleNamespace(trace=bare, steps_per_unit=1)) is None, reader
        assert read(types.SimpleNamespace(trace=None, steps_per_unit=1)) is None
    # Without a profiler no range calls the profiler, and the step's
    # numbers are the same bits.

    def forbidden(*args, **kwargs):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    plain = _one_step()
    for a, b in zip(plain["weights"][0], made[0]["weights"][0]):
        assert torch.equal(a, b)
    for k in plain["losses"][0]:
        assert torch.equal(plain["losses"][0][k], made[0]["losses"][0][k])
