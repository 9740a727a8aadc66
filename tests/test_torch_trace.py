"""The port's profiler ranges (utils/trace.py) at tiny widths on the CPU:
without a profiler a range is one shared null context that calls no
profiler API; under the benchmark's trace (port_bench/trace.py) a G step
with a D step and a batch of hybrid inversion (first guess, evaluation,
two refinement steps) emit every documented range, each inside its
parent; the results are bit-equal with and without the profiler; and the
per-layer metrics that read the ranges give a number from such a trace
and nothing without one. Port-only widths, no JAX reference."""

import copy
import dataclasses
import functools
import math
import os
import types

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch.engine import evaluate, gan, inversion
from nerf_from_image_tpu_torch.engine.render import RenderConfig
from nerf_from_image_tpu_torch.invert import first_guess
from nerf_from_image_tpu_torch.models.discriminator import Discriminator
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.pose import pnp
from nerf_from_image_tpu_torch.utils import trace
from port_bench import harness
from port_bench import trace as bench_trace
from tests.test_torch_generator import release_memory  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
B = 2

# Each documented range, with the ranges it may lie directly inside (None:
# at the top of the unit) on the calling thread.
STEP = ("gan.g_step", "gan.d_step")
RENDER_PARENTS = STEP + ("invert.step", None)
PARENTS = {
    "gan.g_step": (None,), "gan.d_step": (None,),
    "gan.augment": STEP, "gan.disc": STEP, "gan.regularizers": STEP, "gan.backward": STEP,
    "gan.optimizer": STEP,
    "render.synthesis": RENDER_PARENTS, "render.coarse": RENDER_PARENTS,
    "render.fine": RENDER_PARENTS, "render.composite": RENDER_PARENTS,
    "splat.backward": ("gan.backward", "invert.backward"),
    "invert.target_features": (None,), "invert.step": (None,),
    "invert.loss": ("invert.step",), "invert.backward": ("invert.step",),
    "invert.optimizer": ("invert.step",),
    "first_guess.encoder": (None,), "first_guess.pnp": (None,), "eval.metrics": (None,),
}
GAN_RANGES = {n for n in PARENTS if n.split(".")[0] in ("gan", "render", "splat")}
INVERT_RANGES = {n for n in PARENTS if n.split(".")[0] in ("invert", "first_guess", "eval",
                                                           "render", "splat")}
BENCHMARK_SPANS = {"window", "first_guess", "eval", "refine", "g_step", "d_step"}
# The per-layer metrics that read the ranges, and the unit they are read from.
READERS = {"optimizer_ms.train": "gan", "backward_ms.train": "gan",
           "regularizer_ms.train": "gan", "render_ms.train": "gan",
           "pnp_ms.invert": "invert"}


def _generator(seed):
    return Generator(latent_dim=8, scene_range=0.55, attention_values=4, use_sdf=True,
                     w_dim=8, plane_channels=8, synthesis_resolution=8, channel_base=64,
                     channel_max=8, device="cpu", generator=torch.Generator().manual_seed(seed))


def _cameras(n, distance=2.5):
    poses = []
    for angle in np.linspace(0.0, 0.6, n):
        c, s = np.cos(angle), np.sin(angle)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        m[:3, 3] = m[:3, :3] @ np.array([0.0, 0.0, distance])
        poses.append(m)
    return torch.from_numpy(np.stack(poses)), torch.full((n,), 1.2)


@functools.lru_cache(maxsize=1)
def _gan_start():
    """(config, render config, state at iteration 0, real images): a G step
    renders 16^2 in chunks of whole rows with the plane-gradient op, as
    the training cell does, with path length and R1."""
    model = _generator(1)
    disc = Discriminator(16, 3, camera_flipped=False, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    config = gan.GANTrainConfig(batch_size=B, latent_dim=8, white_background=True)
    rc = RenderConfig(resolution=16, depth_samples_per_ray=4, scene_range=0.55,
                      white_background=True, plane_splat=True, query_chunk=256)
    images = torch.rand((B, 16, 16, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
    return config, rc, gan.init_gan_state(config, model, disc), images


def _gan_unit():
    """One G step and one D step from a copy of the start; returns every
    number they made: the metrics and G's, D's and the EMA's parameters."""
    config, rc, start, images = _gan_start()
    state = copy.deepcopy(start)
    pose, focal = _cameras(B, 1.4)
    batch = {"pose": pose, "focal": focal}
    gm = gan.g_step(config, rc, state, batch, torch.Generator().manual_seed(4))
    dm = gan.d_step(config, rc, state, dict(batch, images=images), batch,
                    torch.Generator().manual_seed(5))
    params = [p.detach() for m in (state.model, state.disc, state.ema) for p in m.parameters()]
    return list(gm.values()) + list(dm.values()) + params


@functools.lru_cache(maxsize=1)
def _invert_start():
    """(config, first-guess inputs, invert, eval_fn): the hybrid path at
    32^2 with the MiT encoder's tiny depths, PnP over the focal guesses,
    the crop-augmented `vgg` loss and the plane-gradient op."""
    model = _generator(6).requires_grad_(False)
    encoder = BootstrapEncoder(8, backbone_depths=(1, 1, 1, 1), device="cpu",
                               generator=torch.Generator().manual_seed(7)).requires_grad_(False)
    lpips = LPIPS(torch.Generator().manual_seed(8), device="cpu")
    config = inversion.InversionConfig(steps=2, num_augmentations=1)
    rc = RenderConfig(resolution=32, depth_samples_per_ray=4, scene_range=0.55,
                      plane_splat=True, query_chunk=None)
    target = torch.rand((B, 32, 32, 4), generator=torch.Generator().manual_seed(9)) * 2 - 1
    with torch.no_grad():
        z_avg = model.average_w(generator=torch.Generator().manual_seed(10))
    guesses = pnp.get_focal_guesses(np.linspace(1.0, 1.6, 20))
    invert = inversion.make_invert_fn(config, rc, model, lpips=lpips, device="cpu")
    eval_fn = evaluate.make_eval_fn(config, rc, model, lpips, device="cpu")
    return config, (encoder, target, z_avg, guesses), invert, eval_fn


def _invert_unit():
    """A batch as the inversion driver runs it: first guess, evaluation,
    two refinement steps, evaluation; returns every number it made."""
    config, (encoder, target, z_avg, guesses), invert, eval_fn = _invert_start()
    z0, p0 = first_guess(encoder, target, z_avg, config, guesses, device="cpu")
    first = eval_fn(z0, p0, target)
    z, pose, losses = invert(z0, p0, target, generator=torch.Generator().manual_seed(11))
    last = eval_fn(z, pose, target)
    out = [z0, *[t for t in p0 if t is not None], z, *[t for t in pose if t is not None],
           losses]
    return out + [first[k] for k in sorted(first)] + [last[k] for k in sorted(last)]


UNITS = {"gan": _gan_unit, "invert": _invert_unit}


@functools.lru_cache(maxsize=None)
def _traced(unit):
    """(the reduced trace of one unit, the numbers it made)."""
    torch.manual_seed(0)
    made = []
    summary = bench_trace.profile(lambda: made.extend(UNITS[unit]()), CPU)
    return summary, made


def _parent(span, spans):
    """The shortest range that holds `span`, or None."""
    a, b, name = span
    around = [(e - s, n) for s, e, n in spans if s <= a and b <= e and (s, e) != (a, b)]
    return min(around)[1] if around else None


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert not torch.autograd._profiler_enabled()
    contexts = {id(trace.span(name)) for name in PARENTS}
    assert contexts == {id(trace._NULL)}
    with trace.span("gan.g_step") as entered:
        assert entered is None
    assert trace.spanned("gan.backward")(lambda x: x + 1)(1) == 2


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_a_traced_unit_emits_every_range_inside_its_parent(unit):
    summary, _ = _traced(unit)
    names = {name for _, _, name in summary.spans}
    assert names == (GAN_RANGES if unit == "gan" else INVERT_RANGES), names
    assert not names & BENCHMARK_SPANS
    assert {"gan.backward", "splat.backward"} <= names or {"invert.backward",
                                                           "splat.backward"} <= names
    for span in summary.spans:
        assert span[0] < span[1], span
        assert _parent(span, summary.spans) in PARENTS[span[2]], (span[2],
                                                                  _parent(span, summary.spans))


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_results_are_bit_equal_with_and_without_the_profiler(unit, monkeypatch):
    _, traced = _traced(unit)

    def forbidden(*args, **kwargs):
        raise AssertionError("record_function called without a profiler")

    # Without a profiler no range calls the profiler at all.
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    torch.manual_seed(0)
    plain = UNITS[unit]()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_range_readers_read_the_trace_and_nothing_without_it(metric):
    summary, _ = _traced(READERS[metric])
    read = harness.metric_reader(ROOT, metric).read
    value = read(types.SimpleNamespace(trace=summary, steps_per_unit=1))
    assert math.isfinite(value) and value > 0
    window = (summary.window[1] - summary.window[0]) * 1e-3
    assert value <= window
    bare = dataclasses.replace(summary, spans=[])
    assert read(types.SimpleNamespace(trace=bare, steps_per_unit=1)) is None
    assert read(types.SimpleNamespace(trace=None, steps_per_unit=1)) is None


def test_profile_step_counts_busy_as_a_union_and_names_gaps_by_range():
    """profile_step's reduction on a made-up session: the ranges' device
    copies are no work, overlapping device activities count once, and
    each idle gap goes to the innermost range the host was in."""
    from nerf_from_image_tpu_torch.profile_step import timeline

    def event(name, start, end, device="CPU"):
        return types.SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [
        event("pb.profile_step", 0, 100),
        event("pb.gan.g_step", 0, 60), event("pb.gan.optimizer", 30, 60),
        event("pb.gan.g_step", 5, 55, "CUDA"),  # the range's device copy
        event("kernel_a", 10, 30, "CUDA"), event("kernel_b", 20, 35, "CUDA"),
        event("kernel_c", 50, 70, "CUDA"),
    ]
    window, busy, table = timeline(events, "profile_step")
    assert (window, busy) == (100, 45)
    assert table == {"gan.g_step": [60, 10], "gan.optimizer": [30, 15],
                     "outside ranges": [0.0, 30]}
