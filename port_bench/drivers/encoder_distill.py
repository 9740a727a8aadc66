"""Bootstrap-encoder distillation, as the encoder's training driver runs
it (`train_encoder.main`): each step draws z, renders the frozen
generator's image, mask and canonical coordinates without gradients, and
takes one Adam step of the MiT-B5 encoder (drop path on) towards them,
through `engine/coord_regressor.py::coord_train_step` of the side's
package.

A unit of work is one step of `batch_size` images. The steps are a closed
loop. Cameras come from a pool of `pool` batches of orbit cameras the
traffic draws at set-up; step i takes its rows by a draw keyed by i, and
z, the render's samples and drop path from one generator seeded by
(seed, i). Set-up builds the models from the seed and drives the first
`check_units` steps, which also warm up every shape; the same state then
goes on into the window.

What `correct` reads: the reference builds the same state from the seed
and runs the same first steps with the same cameras and draws. Against
it: the first step's targets (`target_image` as the encoder got it;
`target_mask`, `target_coords`, `target_w` rendered again from that
step's draws), each step's losses (`loss<k>`: the worst of the total and
its three terms), the encoder's first gradient as the optimizer got it
(Adam's first moment after one step over 1 - b1) by the worst leaf
(`grad`), and the change of the encoder's weights over those steps, read
before the window, by the worst leaf (`change`; leaves whose reference
gradient is under a thousandth of the median leaf's are left out, as in
training). The cell's file holds the limits of those that are compared.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List

import torch

from port_bench import compare, faults, traffic
from port_bench.counts import flops
from port_bench.programs import Side, build, seeded_generator

# The faults `plant` can put under this driver, each of which `correct`
# catches: an optimizer that does not move the encoder; half of the batch
# left out of each step; the weight of the coordinate head's middle
# convolution (its largest leaf) moved double in each step.
FAULTS = ("unchanged", "half_batch", "altered")


def regressor(side: Side):
    """The side's engine/coord_regressor.py (a planted one if the side
    carries it), found by the side's package name."""
    planted = side.__dict__.get("coord_regressor")
    if planted is not None:
        return planted
    return importlib.import_module(f"{side.package}.engine.coord_regressor")


def _norms_of_change(now, before) -> List[float]:
    return [float(torch.linalg.vector_norm((a.detach() - b).double())) for a, b in zip(now, before)]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.side = ctx.side
        self.first: Dict[str, object] = {}
        self.unit_failed: List[torch.Tensor] = []
        self.notes: Dict[str, object] = {}
        self.step_index = 0

    # --- set-up ------------------------------------------------------------

    def build(self):
        ctx, side, dev = self.ctx, self.side, self.ctx.device
        c, t = ctx.config, ctx.traffic
        g, r, e, ds = c["generator"], c["render"], c["encoder"], c["dataset"]
        d = c["distillation"]
        self.cr = regressor(side)
        self.batch = c["batch_size"]
        self.model = build(side, lambda s, dv, gen: s.generator.Generator(
            latent_dim=g["latent_dim"], scene_range=ds["scene_range"],
            attention_values=g["attention_values"], use_viewdir=g["use_viewdir"],
            use_sdf=g["use_sdf"], w_dim=g["w_dim"], plane_channels=g["plane_channels"],
            synthesis_resolution=g["synthesis_resolution"], device=dv, generator=gen),
            (ctx.seed, 1), dev).requires_grad_(False)
        self.encoder = build(side, lambda s, dv, gen: s.encoder.BootstrapEncoder(
            latent_dim=g["w_dim"], separate_backbones=e["separate_backbones"],
            backbone_depths=tuple(e["depths"]), device=dv, generator=gen), (ctx.seed, 2), dev)
        self.leaf_names = [n for n, _ in self.encoder.named_parameters()]
        self.config = self.cr.CoordRegressorConfig(
            latent_dim=g["latent_dim"], lr=d["lr"], max_iters=d["max_iters"],
            lr_drop_at=d["lr_drop_at"])
        self.render_cfg = side.render.RenderConfig(
            resolution=r["resolution"], depth_samples_per_ray=r["depth_samples_per_ray"],
            fine_sampling=r["fine_sampling"], scene_range=ds["scene_range"],
            white_background=ds["white_background"], use_viewdir=g["use_viewdir"],
            query_chunk=r["query_chunk"] or None, merge_mode=r["merge_mode"])
        self.opt = self.cr.make_optimizer(self.config, self.encoder)
        gen = seeded_generator(dev, ctx.seed, 5)
        cams = traffic.cameras(gen, t["pool"] * self.batch, t["camera"], dev)
        self.poses, self.focals = cams["pose"], cams["focal"]

    def _batch(self, i: int) -> Dict[str, torch.Tensor]:
        """Step i's cameras: B distinct rows of the pool, keyed by i; no
        center or bbox, as the P3D train split has none."""
        rows = torch.randperm(self.poses.shape[0], device=self.ctx.device,
                              generator=seeded_generator(self.ctx.device, self.ctx.seed, 8,
                                                         i))[:self.batch]
        return {"pose": self.poses[rows], "focal": self.focals[rows]}

    def _step(self) -> Dict[str, torch.Tensor]:
        """The next step of the loop; returns its losses, on the device."""
        dev, i = self.ctx.device, self.step_index
        self.step_index += 1
        return self.cr.coord_train_step(self.config, self.render_cfg, self.model, self.encoder,
                                         self.opt, self._batch(i),
                                         seeded_generator(dev, self.ctx.seed, 9, i), device=dev)

    def _targets_again(self, i: int) -> Dict[str, torch.Tensor]:
        """Step i's mask, coordinates and w, rendered again from its draws
        (z first, then the render's samples, as the step takes them)."""
        dev = self.ctx.device
        gen = seeded_generator(dev, self.ctx.seed, 9, i)
        z = self.cr.mesh.draw(torch.randn, (self.batch, self.config.latent_dim), generator=gen,
                              device=dev)
        image, mask, coords, w = self.cr.render_targets(self.render_cfg, self.model,
                                                        self._batch(i), z, gen, dev)
        return {"image_again": image, "mask": mask, "coords": coords, "w": w}

    def first_units(self) -> Dict[str, object]:
        """The first `check_units` steps, with what correct reads of them:
        the first step's targets, every step's losses, the encoder's first
        gradient as the optimizer got it and the change of its weights."""
        leaves = list(self.encoder.parameters())
        before = [p.detach().clone() for p in leaves]
        seen = []
        hook = self.encoder.register_forward_pre_hook(
            lambda module, args: seen.append(args[0].detach().clone()))
        out = {"losses": [], "grad": []}
        for q in range(self.ctx.cell["check_units"]):
            first = self.step_index
            losses = self._step()
            out["losses"].append({k: float(v) for k, v in losses.items()})
            if q == 0:
                hook.remove()
                out["targets"] = dict(self._targets_again(first), image=seen[0])
                out["grad"] = [n / (1.0 - self.opt.b1) for n in compare.leaf_norms(self.opt.mu)]
        out["change"] = _norms_of_change(leaves, before)
        return out

    def setup(self):
        self.build()
        self.first = self.first_units()
        self.k1_before = self.side.k1_launches()

    # --- the window --------------------------------------------------------

    @property
    def images_per_unit(self) -> int:
        return self.batch

    @property
    def steps_per_unit(self) -> int:
        return 1

    def unit(self, i: int, spans) -> None:
        losses = self._step()
        self.unit_failed.append(~torch.isfinite(torch.stack(list(losses.values()))).all())

    def failed(self, n_units: int) -> int:
        """Images of the window's steps with a non-finite loss."""
        return self.batch * int(sum(int(f) for f in self.unit_failed[:n_units]))

    def end_to_end(self, n_units: int, window_s: float) -> Dict[str, float]:
        return {"train_images_per_s": n_units * self.batch / window_s}

    def release(self) -> None:
        """Frees the side's modules and optimizer; notes the plane-gradient
        kernel's launches since set-up (0: the target render takes no
        gradient)."""
        if self.k1_before is not None:
            self.notes["k1_launches_after_setup"] = self.side.k1_launches() - self.k1_before
        self.model = self.encoder = self.opt = None

    # --- correct -------------------------------------------------------------

    def check(self, ref_side, n_units: int) -> Dict[str, float]:
        ref = Driver(self.ctx.with_side(ref_side))
        ref.build()
        want, got = ref.first_units(), self.first
        out = {}
        for name in ("image", "mask", "coords", "w"):
            out[f"target_{name}"] = compare.rel_max(got["targets"][name],
                                                    want["targets"][name])
        for side, first in (("program", got), ("reference", want)):
            self.notes[f"{side}_target_image_rendered_again"] = compare.rel_max(
                first["targets"]["image_again"], first["targets"]["image"])
        for q, (a, b) in enumerate(zip(got["losses"], want["losses"])):
            out[f"loss{q}"] = compare.rel_each([a.get(k, math.nan) for k in b],
                                               [b[k] for k in b])
        names = ref.leaf_names
        out["grad"] = compare.worst_leaf(got["grad"], want["grad"])
        gaps = compare.leaf_gaps(got["grad"], want["grad"])
        worst = max(range(len(gaps)), key=gaps.__getitem__)
        self.notes["grad_worst_leaf"] = [names[worst], got["grad"][worst], want["grad"][worst]]
        keep = compare.moved(want["grad"])
        out["change"] = compare.worst_leaf(got["change"], want["change"], keep)
        kept = [n for n, on in zip(names, keep) if on]
        gaps = compare.leaf_gaps(got["change"], want["change"], keep)
        self.notes["change_worst_leaf"] = kept[max(range(len(gaps)), key=gaps.__getitem__)]
        self.notes["change_left_out"] = [n for n, on in zip(names, keep) if not on]
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def plant(side: Side, fault: str) -> Side:
    """The program `side` with one of FAULTS planted."""
    cr = regressor(side)
    if fault == "unchanged":
        def make_optimizer(*a, **k):
            opt = cr.make_optimizer(*a, **k)
            opt.step = lambda grads: None
            return opt

        return faults.replaced(side, coord_regressor=faults.module(
            cr, make_optimizer=make_optimizer))
    if fault == "half_batch":
        def coord_train_step(config, rc, model, encoder, opt, batch, *a, **k):
            return cr.coord_train_step(config, rc, model, encoder, opt, faults.half(batch),
                                       *a, **k)
    else:
        def coord_train_step(config, rc, model, encoder, *a, **k):
            leaf = dict(encoder.named_parameters())["post.2.weight"]
            before = leaf.detach().clone()
            losses = cr.coord_train_step(config, rc, model, encoder, *a, **k)
            with torch.no_grad():
                leaf.add_(leaf - before)
            return losses

    return faults.replaced(side, coord_regressor=faults.module(
        cr, coord_train_step=coord_train_step))


def count_flops(files: Dict) -> Dict[str, object]:
    """Model FLOPs of a step: the target render (mapping, synthesis, field
    queries, no gradient) and the encoder's forward and backward."""
    d = flops.meta_driver(files, Driver)
    targets = flops.flops_of(lambda: d._targets_again(0))
    step = flops.flops_of(d._step)
    return {"flops_per_unit": step, "flops": {"targets": targets, "encoder": step - targets}}
