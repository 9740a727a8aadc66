"""Hybrid inversion, as the inversion driver runs it a batch at a time
(`invert.main`): the first guess (MiT-B5 encoder, PnP over the focal
guesses), the evaluation at step 0, the Adam refinement through the
render, the evaluation at the last step.

A unit of work is one batch. The batches are a closed loop: each starts
when the one before it has ended. Batch i inverts target set i mod
`target_sets` of the traffic, with its own draws for the refinement.

What `correct` compares, on one batch of the window drawn from the seed:
- the encoder's coordinates and mask, and the first guess's w, against
  the reference's encoder on the same targets (`enc_coords`, `enc_mask`,
  `first_guess_w`);
- the PnP pose, against the reference's PnP on the program's coordinates
  and mask (`pnp_pose`; PnP thresholds the mask, so a rounding-level gap
  in it could flip pixels: the reference follows the program's state
  here, and the encoder is checked by itself above);
- the evaluation at step 0 and at the last step, against the reference's
  evaluation of the program's (w, pose) at those steps (`eval_first`,
  `eval_last`);
- the refinement: the reference runs the first `check_steps` steps from
  the program's first guess with the same draws, and the losses of those
  steps (each after the updates before it) are compared (`refine_loss`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from port_bench import compare, faults, traffic
from port_bench.counts import flops, k1
from port_bench.programs import Side, build, seeded_generator

# The faults `plant` can put under this driver: a refinement that returns
# the first guess, with its first loss for every step; half of the batch
# left out of the refinement; one image's PSNR altered in each evaluation.
FAULTS = ("unchanged", "half_batch", "altered")


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.side = ctx.side
        self.records: List[Dict] = []
        self._encoder_out = None
        self.notes: Dict[str, object] = {}

    # --- set-up ------------------------------------------------------------

    def build(self):
        """The side's modules, configurations and inputs."""
        ctx, side, dev = self.ctx, self.side, self.ctx.device
        c, t = ctx.config, ctx.traffic
        g, r, inv, ds = c["generator"], c["render"], c["inversion"], c["dataset"]
        self.batch = c["batch_size"]
        self.model = build(side, lambda s, d, gen: s.generator.Generator(
            latent_dim=g["latent_dim"], scene_range=ds["scene_range"],
            attention_values=g["attention_values"], use_viewdir=g["use_viewdir"],
            use_sdf=g["use_sdf"], w_dim=g["w_dim"], plane_channels=g["plane_channels"],
            synthesis_resolution=g["synthesis_resolution"], device=d, generator=gen),
            (ctx.seed, 1), dev).requires_grad_(False)
        self.encoder = build(side, lambda s, d, gen: s.encoder.BootstrapEncoder(
            latent_dim=g["w_dim"], backbone_depths=tuple(c["encoder"]["depths"]),
            device=d, generator=gen), (ctx.seed, 2), dev).requires_grad_(False)
        self.lpips = build(side, lambda s, d, gen: s.lpips.LPIPS(gen, device=d),
                           (ctx.seed, 3), dev)
        self.inv_cfg = side.inversion.InversionConfig(
            steps=inv["steps"], lr=inv["lr"], lr_gain_z=inv["lr_gain_z"], loss=inv["loss"],
            num_augmentations=inv["num_augmentations"], optimize_pose=inv["optimize_pose"],
            camera_flipped=ds["camera_flipped"], white_background=ds["white_background"])
        self.render_cfg = side.render.RenderConfig(
            resolution=r["resolution"], depth_samples_per_ray=r["depth_samples_per_ray"],
            fine_sampling=r["fine_sampling"], scene_range=ds["scene_range"],
            white_background=ds["white_background"], query_chunk=r["query_chunk"] or None,
            merge_mode=r["merge_mode"], plane_splat=side.plane_splat and r["plane_splat"])
        self.invert = side.inversion.make_invert_fn(self.inv_cfg, self.render_cfg, self.model,
                                                    lpips=self.lpips, device=dev)
        self.eval_fn = side.evaluate.make_eval_fn(self.inv_cfg, self.render_cfg, self.model,
                                                  self.lpips, has_mask=ds["has_mask"],
                                                  device=dev)
        gen = seeded_generator(dev, ctx.seed, 4)
        with torch.no_grad():
            self.z_avg = (torch.zeros((1, self.model.num_ws, g["w_dim"]), device=dev)
                          if gen is None else self.model.average_w(generator=gen))
        self.guesses = side.pnp.get_focal_guesses(np.linspace(*c["focal_guesses_from"]))
        gen = seeded_generator(dev, ctx.seed, 5)
        sets, B, res = t["target_sets"], self.batch, r["resolution"]
        self.targets = traffic.images(gen, sets * B, res, t["image"], dev).reshape(
            sets, B, res, res, 4)
        cams = traffic.cameras(gen, sets * B, dict(t["camera"], flipped=ds["camera_flipped"]),
                               dev)
        self.poses = cams["pose"].reshape(sets, B, 4, 4)
        self.encoder.register_forward_hook(self._keep_encoder_out)

    def _keep_encoder_out(self, module, inputs, outputs):
        self._encoder_out = tuple(o.clone() for o in outputs)

    def setup(self):
        """Builds the side and warms every shape the window runs: a first
        guess, an evaluation and a refinement of two steps (the first Adam
        step makes the optimizer's state)."""
        self.build()
        target, pose = self.targets[0], self.poses[0]
        z0, p0 = self.side.first_guess(self.encoder, target, self.z_avg, self.inv_cfg,
                                       self.guesses, device=self.ctx.device)
        self.eval_fn(z0, p0, target, pose)
        self.invert(z0, p0, target, generator=seeded_generator(self.ctx.device, 0), n_steps=2)

    # --- the window --------------------------------------------------------

    @property
    def images_per_unit(self) -> int:
        return self.batch

    @property
    def steps_per_unit(self) -> int:
        return self.inv_cfg.steps

    def unit(self, i: int, spans) -> None:
        ctx, side = self.ctx, self.side
        k = i % self.targets.shape[0]
        target, pose = self.targets[k], self.poses[k]
        with spans("first_guess"):
            z0, p0 = side.first_guess(self.encoder, target, self.z_avg, self.inv_cfg,
                                      self.guesses, device=ctx.device)
        enc = self._encoder_out
        with spans("eval"):
            m0 = self.eval_fn(z0, p0, target, pose)
        with spans("refine", count=self.inv_cfg.steps):
            z, p, losses = self.invert(z0, p0, target,
                                       generator=seeded_generator(ctx.device, ctx.seed, 6, i),
                                       n_steps=self.inv_cfg.steps)
        with spans("eval"):
            mn = self.eval_fn(z, p, target, pose)
        self.records.append({"i": i, "k": k, "enc": enc, "z0": z0, "p0": p0, "m0": m0,
                             "losses": losses, "z": z, "p": p, "mn": mn})

    def failed(self, n_units: int) -> int:
        """Images of the window's batches with a non-finite loss, latent,
        pose or metric."""
        bad = 0
        for rec in self.records[:n_units]:
            ok = torch.isfinite(rec["z"]).flatten(1).all(1)
            ok &= bool(torch.isfinite(rec["losses"]).all())
            for leaf in rec["p"]:
                if leaf is not None:
                    ok &= torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(1)
            for m in (rec["m0"], rec["mn"]):
                for v in m.values():
                    ok &= torch.isfinite(v).reshape(v.shape[0], -1).all(1)
            bad += int((~ok).sum())
        return bad

    def end_to_end(self, n_units: int, window_s: float) -> Dict[str, float]:
        return {"invert_images_per_s": n_units * self.batch / window_s}

    def release(self) -> None:
        """Frees the side's modules and closures; the records stay."""
        for name in ("model", "encoder", "lpips", "invert", "eval_fn", "z_avg"):
            setattr(self, name, None)

    # --- correct -------------------------------------------------------------

    def check(self, ref_side, n_units: int) -> Dict[str, float]:
        ctx, dev = self.ctx, self.ctx.device
        rng = np.random.default_rng([ctx.seed, 7])
        rec = self.records[int(rng.integers(max(1, n_units)))]
        ref = Driver(ctx.with_side(ref_side))
        ref.build()
        target, pose = ref.targets[rec["k"]], ref.poses[rec["k"]]
        got = {}
        with torch.no_grad():
            coords, mask, w = ref.encoder(target[..., :3])
        got["enc_coords"] = compare.rel_max(rec["enc"][0], coords)
        got["enc_mask"] = compare.rel_max(rec["enc"][1], mask)
        z0 = w.expand((target.shape[0],) + tuple(ref.z_avg.shape[1:])) / ref.inv_cfg.lr_gain_z
        got["first_guess_w"] = compare.rel_max(rec["z0"], z0)
        del coords, mask, w, z0
        with torch.no_grad():
            cam, focal, _ = ref_side.pnp.estimate_poses_batch(rec["enc"][0], rec["enc"][1],
                                                              ref.guesses)
        want = ref_side.inversion.pose_params_from_matrix(cam, focal, ref.inv_cfg.camera_flipped)
        got["pnp_pose"] = max(compare.rel_max(a, b) for a, b in zip(rec["p0"], want)
                              if b is not None)
        got["eval_first"] = compare.metrics_gap(rec["m0"], ref.eval_fn(rec["z0"], rec["p0"],
                                                                       target, pose))
        steps = ctx.cell["check_steps"]
        _, _, losses = ref.invert(rec["z0"], rec["p0"], target,
                                  generator=seeded_generator(dev, ctx.seed, 6, rec["i"]),
                                  n_steps=steps)
        steps_got, steps_want = rec["losses"][:steps].tolist(), losses.tolist()
        got["refine_loss"] = compare.rel_each(steps_got, steps_want)
        self.notes["refine_loss_steps"] = [compare.rel_each([a], [b])
                                           for a, b in zip(steps_got, steps_want)]
        got["eval_last"] = compare.metrics_gap(rec["mn"], ref.eval_fn(rec["z"], rec["p"],
                                                                      target, pose))
        return {k: (v if math.isfinite(v) else math.inf) for k, v in got.items()}


def plant(side: Side, fault: str) -> Side:
    """The program `side` with one of FAULTS planted."""
    inversion, evaluate = side.inversion, side.evaluate
    if fault == "altered":
        def make_eval_fn(*args, **kwargs):
            eval_fn = evaluate.make_eval_fn(*args, **kwargs)

            def altered(*a, **k):
                metrics = eval_fn(*a, **k)
                metrics["psnr"] = metrics["psnr"].clone()
                metrics["psnr"][0] += 0.5
                return metrics

            return altered

        return faults.replaced(side, evaluate=faults.module(evaluate, make_eval_fn=make_eval_fn))

    def make_invert_fn(config, *args, **kwargs):
        invert = inversion.make_invert_fn(config, *args, **kwargs)

        def broken(z, pose, target, generator=None, center=None, bbox=None, n_steps=None):
            n = config.steps if n_steps is None else n_steps
            if fault == "unchanged":
                _, _, losses = invert(z, pose, target, generator, center, bbox, n_steps=1)
                return z, pose, losses.repeat(n)
            h = z.shape[0] // 2
            half = type(pose)(*(None if t is None else t[:h] for t in pose))
            zh, ph, losses = invert(z[:h], half, target[:h], generator, center, bbox, n)
            pose_out = type(pose)(*(None if a is None else torch.cat((b, a[h:]))
                                    for a, b in zip(pose, ph)))
            return torch.cat((zh, z[h:])), pose_out, losses

        return broken

    return faults.replaced(side, inversion=faults.module(inversion,
                                                         make_invert_fn=make_invert_fn))


def count_flops(files: Dict) -> Dict[str, object]:
    """Model FLOPs of a batch: the first guess's encoder, two evaluations,
    the refinement call's target features and its steps."""
    d = flops.meta_driver(files, Driver)
    ref, meta = d.side, flops.META
    target, pose = d.targets[0], d.poses[0]
    focal = torch.ones(target.shape[0], device=meta)
    p = ref.inversion.pose_params_from_matrix(pose, focal, d.inv_cfg.camera_flipped)
    z = (d.z_avg.expand(target.shape[0], -1, -1) / d.inv_cfg.lr_gain_z)

    def first_guess():
        with torch.no_grad():
            d.encoder(target[..., :3])

    def evaluate():
        d.eval_fn(z, p, target, pose)

    def refine_call():
        with torch.no_grad():
            d.lpips.features(target[..., :3])

    def refine_step():
        leaves = [z.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for t in p if t is not None]
        pose_leaves = ref.inversion.PoseParams(
            *([None] if p.z0 is None else []), *leaves[1:])
        cam, foc = ref.inversion.build_camera(pose_leaves, d.inv_cfg.camera_flipped)
        out, _ = ref.render.render(d.render_cfg, d.model, cam, foc,
                                   leaves[0] * d.inv_cfg.lr_gain_z, device=meta)
        loss = ref.inversion.reconstruction_loss(d.inv_cfg, d.lpips, out.rgb[..., :3],
                                                 target[..., :3])
        torch.autograd.grad(loss, leaves)

    parts = {"first_guess": flops.flops_of(first_guess), "eval": flops.flops_of(evaluate),
             "refine_call": flops.flops_of(refine_call),
             "refine_step": flops.flops_of(refine_step)}
    per_unit = (parts["first_guess"] + 2 * parts["eval"] + parts["refine_call"]
                + d.inv_cfg.steps * parts["refine_step"])
    return {"flops_per_unit": per_unit, "flops": parts,
            "k1_bound_ms_per_unit": d.inv_cfg.steps * k1.render_bound_ms(files["config"])}
