"""GAN training, as the training driver runs it (`train.main`): G steps
at even iterations and D steps at odd ones, each with its own draws from
a generator keyed by the iteration; the G step also updates the EMA
generator and clamps the SDF parameters.

A unit of work is one iteration of training: one G step and one D step.
Set-up builds the train state from the seed and drives it through its
first `check_units` iterations, which also warm up every shape; the same
state then goes on into the window. Real images and cameras come from
pools of `pool` batches the traffic draws at set-up; iteration i takes
pool entries by its draw numbers, as the driver's sampler does.

What `correct` reads: the reference builds the same state from the
seed and runs the same first iterations, with the same batches and
draws. Against it: each step's losses (`g_loss<k>`, `d_loss<k>`: the
worst over the step's losses), the first gradient of G and of D as the
optimizer got it (Adam's first moment after the first step, with b1 = 0
the clipped gradient itself), by the worst leaf (`g_grad`, `d_grad`),
and the change of G, of D and of the EMA generator over those
iterations, read before the window's first step, by the worst leaf
(`g_change`, `d_change`, `ema_change`). Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the changes:
they move under Adam by round-off alone. The cell's file holds the
limits of those that are compared.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from port_bench import compare, faults, traffic
from port_bench.counts import flops, k1
from port_bench.harness import no_spans
from port_bench.programs import Side, build, seeded_generator

# The faults `plant` can put under this driver, each of which `correct`
# catches: G's optimizer that does not move G; D's that does not move D;
# half of the batch left out of both steps; G's largest leaf moved double
# in each G step.
FAULTS = ("unchanged", "d_unchanged", "half_batch", "altered")
# Planted for its readings only: R1's gradient taken without its graph,
# so that its double backward is gone and D's gradient lacks R1's part
# while its value stays. From random weights R1's part of D's first
# gradients is under the sound runs' spread, so no limit catches it.
UNCAUGHT = ("r1_detached",)


def _norms_of_change(now, before) -> List[float]:
    return [float(torch.linalg.vector_norm((a.detach() - b).double())) for a, b in zip(now, before)]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.side = ctx.side
        self.first: Dict[str, object] = {}
        self.unit_failed: List[torch.Tensor] = []
        self.notes: Dict[str, object] = {}

    # --- set-up ------------------------------------------------------------

    def build(self):
        ctx, side, dev = self.ctx, self.side, self.ctx.device
        c, t = ctx.config, ctx.traffic
        g, r, tr, ds = c["generator"], c["render"], c["training"], c["dataset"]
        self.batch = c["batch_size"]
        model = build(side, lambda s, d, gen: s.generator.Generator(
            latent_dim=g["latent_dim"], scene_range=ds["scene_range"],
            attention_values=g["attention_values"], use_viewdir=g["use_viewdir"],
            use_sdf=g["use_sdf"], w_dim=g["w_dim"], plane_channels=g["plane_channels"],
            synthesis_resolution=g["synthesis_resolution"], device=d, generator=gen),
            (ctx.seed, 1), dev)
        disc = build(side, lambda s, d, gen: s.discriminator.Discriminator(
            resolution=r["resolution"], nc=3, camera_flipped=ds["camera_flipped"],
            conditional_pose=tr["conditional_pose"], device=d, generator=gen),
            (ctx.seed, 2), dev)
        self.config = side.gan.GANTrainConfig(
            batch_size=self.batch, latent_dim=g["latent_dim"], lr_g=tr["lr_g"], lr_d=tr["lr_d"],
            clip_gradient_norm=tr["clip_gradient_norm"], r1=tr["r1"], eikonal=tr["eikonal"],
            tv=tr["tv"], entropy=tr["entropy"],
            path_length_regularization=tr["path_length_regularization"],
            conditional_pose=tr["conditional_pose"], white_background=ds["white_background"],
            camera_flipped=ds["camera_flipped"], augment_p=tr["augment_p"],
            noise_mode=tr["noise_mode"], use_sdf=g["use_sdf"])
        self.render_cfg = side.render.RenderConfig(
            resolution=r["resolution"], depth_samples_per_ray=r["depth_samples_per_ray"],
            fine_sampling=r["fine_sampling"], scene_range=ds["scene_range"],
            white_background=ds["white_background"], query_chunk=r["query_chunk"] or None,
            merge_mode=r["merge_mode"], plane_splat=side.plane_splat and r["plane_splat"])
        self.state = side.gan.init_gan_state(self.config, model, disc)
        self.state_names = {"g": list(model.named_parameters()),
                            "d": list(disc.named_parameters())}
        gen = seeded_generator(dev, ctx.seed, 5)
        n, B = t["pool"], self.batch
        self.images = traffic.images(gen, n * B, r["resolution"], t["image"], dev)[..., :3]
        cams = traffic.cameras(gen, n * B, dict(t["camera"], flipped=ds["camera_flipped"]), dev)
        self.poses, self.focals = cams["pose"], cams["focal"]

    def _batch(self, draw: int, with_images: bool) -> Dict[str, torch.Tensor]:
        """Batch `draw` of the pool: B distinct rows, keyed by the draw."""
        rows = torch.randperm(self.poses.shape[0], device=self.ctx.device,
                              generator=seeded_generator(self.ctx.device, self.ctx.seed, 8,
                                                         draw))[:self.batch]
        out = {"pose": self.poses[rows], "focal": self.focals[rows]}
        if with_images:
            out["images"] = self.images[rows]
        return out

    def _iteration(self, spans) -> Dict[str, torch.Tensor]:
        """One iteration: the G step of the state's iteration i, the D step
        of i + 1; returns their metrics, 'g.' and 'd.' before the names."""
        gan, state, dev, seed = self.side.gan, self.state, self.ctx.device, self.ctx.seed
        i = state.iteration
        with spans("g_step"):
            gm = gan.g_step(self.config, self.render_cfg, state, self._batch(4 * i, False),
                            seeded_generator(dev, seed, 9, i))
        i = state.iteration
        with spans("d_step"):
            dm = gan.d_step(self.config, self.render_cfg, state, self._batch(4 * i, True),
                            self._batch(4 * i + 1, False), seeded_generator(dev, seed, 9, i))
        return {**{f"g.{k}": v for k, v in gm.items()}, **{f"d.{k}": v for k, v in dm.items()}}

    def first_units(self) -> Dict[str, object]:
        """The first `check_units` iterations, with what correct reads of
        them: every step's losses, the first gradients of G and D as their
        optimizers got them, and the change of G, D and the EMA."""
        s = self.state
        leaves = {"g": list(s.model.parameters()), "d": list(s.disc.parameters()),
                  "ema": list(s.ema.parameters())}
        before = {k: [p.detach().clone() for p in v] for k, v in leaves.items()}
        out = {"metrics": [], "grad": {}}
        for q in range(self.ctx.cell["check_units"]):
            metrics = {k: float(v) for k, v in self._iteration(no_spans).items()}
            out["metrics"].append(metrics)
            if q == 0:
                # The gradient the optimizer got, before its clip: Adam's first
                # moment after one step is the clipped gradient (b1 = 0), and
                # the step's norm says by how much it was clipped.
                clip = self.config.clip_gradient_norm
                out["grad"] = {
                    k: [n * max(1.0, metrics[f"{k}.grad_norm_{k}"] / clip)
                        for n in compare.leaf_norms(opt.mu)]
                    for k, opt in (("g", s.opt_g), ("d", s.opt_d))}
        out["change"] = {k: _norms_of_change(leaves[k], before[k]) for k in leaves}
        return out

    def setup(self):
        self.build()
        self.first = self.first_units()

    # --- the window --------------------------------------------------------

    @property
    def images_per_unit(self) -> int:
        return self.batch

    @property
    def steps_per_unit(self) -> int:
        return 1

    def unit(self, i: int, spans) -> None:
        metrics = self._iteration(spans)
        self.unit_failed.append(~torch.isfinite(torch.stack(
            [v.float() for v in metrics.values()])).all())

    def failed(self, n_units: int) -> int:
        """Images of the window's iterations with a non-finite loss or norm."""
        return self.batch * int(sum(int(f) for f in self.unit_failed[:n_units]))

    def end_to_end(self, n_units: int, window_s: float) -> Dict[str, float]:
        return {"train_images_per_s": n_units * self.batch / window_s}

    def release(self) -> None:
        self.state = None

    # --- correct -------------------------------------------------------------

    def check(self, ref_side, n_units: int) -> Dict[str, float]:
        ref = Driver(self.ctx.with_side(ref_side))
        ref.build()
        want, got = ref.first_units(), self.first
        out = {}
        for q, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            for step in ("g", "d"):
                keys = [k for k in b if k.startswith(step + ".loss")]
                out[f"{step}_loss{q}"] = compare.rel_each([a.get(k, math.nan) for k in keys],
                                                          [b[k] for k in keys])
        names = {k: [n for n, _ in v] for k, v in self.state_names.items()}
        for k in ("g", "d"):
            out[f"{k}_grad"] = compare.worst_leaf(got["grad"][k], want["grad"][k])
            gaps = compare.leaf_gaps(got["grad"][k], want["grad"][k])
            worst = max(range(len(gaps)), key=gaps.__getitem__)
            norm = f"{k}.grad_norm_{k}"
            self.notes[f"{k}_grad_worst_leaf"] = [names[k][worst], got["grad"][k][worst],
                                                  want["grad"][k][worst]]
            self.notes[f"{k}_first_grad_norm"] = [got["metrics"][0][norm],
                                                  want["metrics"][0][norm]]
        keep = {"g": compare.moved(want["grad"]["g"]), "d": compare.moved(want["grad"]["d"])}
        keep["ema"] = keep["g"]
        names["ema"] = names["g"]
        for k in ("g", "d", "ema"):
            out[f"{k}_change"] = compare.worst_leaf(got["change"][k], want["change"][k], keep[k])
            kept = [n for n, on in zip(names[k], keep[k]) if on]
            gaps = compare.leaf_gaps(got["change"][k], want["change"][k], keep[k])
            self.notes[f"{k}_change_worst_leaf"] = kept[max(range(len(gaps)),
                                                            key=gaps.__getitem__)]
            self.notes[f"{k}_change_left_out"] = [n for n, on in zip(names[k], keep[k])
                                                  if not on]
        return out


def plant(side: Side, fault: str) -> Side:
    """The program `side` with one of FAULTS planted."""
    gan = side.gan
    if fault in ("unchanged", "d_unchanged"):
        opt = "opt_g" if fault == "unchanged" else "opt_d"

        def init_gan_state(*args, **kwargs):
            state = gan.init_gan_state(*args, **kwargs)
            getattr(state, opt).step = lambda grads: None
            return state

        return faults.replaced(side, gan=faults.module(gan, init_gan_state=init_gan_state))
    if fault == "r1_detached":
        def d_step(*a, **k):
            grad = torch.autograd.grad

            def detached(outputs, inputs, *args, create_graph=False, **kw):
                if create_graph:
                    kw["retain_graph"] = True
                return grad(outputs, inputs, *args, **kw)

            torch.autograd.grad = detached
            try:
                return gan.d_step(*a, **k)
            finally:
                torch.autograd.grad = grad

        return faults.replaced(side, gan=faults.module(gan, d_step=d_step))
    if fault == "half_batch":
        def g_step(config, rc, state, batch, generator=None, *a, **k):
            cfg = dataclasses.replace(config, batch_size=config.batch_size // 2)
            return gan.g_step(cfg, rc, state, faults.half(batch), generator, *a, **k)

        def d_step(config, rc, state, real, fake, generator=None, *a, **k):
            cfg = dataclasses.replace(config, batch_size=config.batch_size // 2)
            return gan.d_step(cfg, rc, state, faults.half(real), faults.half(fake), generator,
                              *a, **k)

        return faults.replaced(side, gan=faults.module(gan, g_step=g_step, d_step=d_step))

    def g_step(config, rc, state, *a, **k):
        leaf = max(state.model.parameters(), key=lambda p: p.numel())
        before = leaf.detach().clone()
        metrics = gan.g_step(config, rc, state, *a, **k)
        with torch.no_grad():
            leaf.add_(leaf - before)
        return metrics

    return faults.replaced(side, gan=faults.module(gan, g_step=g_step))


def count_flops(files: Dict) -> Dict[str, object]:
    """Model FLOPs of an iteration: a G step and a D step."""
    d = flops.meta_driver(files, Driver)

    def g_step():
        d.side.gan.g_step(d.config, d.render_cfg, d.state, d._batch(0, False), None)

    def d_step():
        d.side.gan.d_step(d.config, d.render_cfg, d.state, d._batch(1, True),
                          d._batch(2, False), None)

    parts = {"g_step": flops.flops_of(g_step), "d_step": flops.flops_of(d_step)}
    return {"flops_per_unit": parts["g_step"] + parts["d_step"], "flops": parts,
            "k1_bound_ms_per_unit": k1.render_bound_ms(files["config"])}
