"""Adversarial training engine: the G and D steps.

Counterpart of nerf_from_image_tpu/engine/gan.py (the reference's GAN
loop, run.py:947-1518): ADA augmentation, the warm-up blur, the render,
the discriminator, R1 (a gradient of a gradient), the eikonal, TV,
entropy and path-length regularizers, Adam with a learning-rate warm-up
and gradient clipping, EMA, the ADA p update and the SDF parameter clamp.
The G step runs at even iterations and the D step at odd ones. Both
update a GANState in place.

The optimizers are optax's chain, written out (Optimizer):
clip_by_global_norm, which scales by max_norm / norm only when norm >=
max_norm, then Adam (b1 = 0, b2 = 0.99, eps = 1e-8), then the learning
rate min(target / 10 + delta * count, target) at the optimizer's own
update count from 0.

On several ranks (parallel/mesh.py) each step runs on the rank's rows of
the global batch: its draws are the global draws' rows, its gradients
are averaged over ranks by one flattened all-reduce before the clip (where
the JAX step's psum sits), and the statistics that couple the batch (the
path-length mean, ADA's sign, every metric) are all-reduced, so the world
size changes no number.

Random draws come from one torch.Generator per step; every draw can also
be handed in through `draws` (the latents 'z', the augmentation
transforms, the regularizers' 'bins' and 'perturb', the path-length
'ppl_noise'), which the parity tests do. The render is the deterministic
one when `generator` is None.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_from_image_tpu_torch.engine import augment as augment_mod
from nerf_from_image_tpu_torch.engine import regularizers
from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
from nerf_from_image_tpu_torch.ops import filters
from nerf_from_image_tpu_torch.parallel import mesh
from nerf_from_image_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    batch_size: int = 32
    latent_dim: int = 512
    lr_g: float = 0.0025
    lr_d: float = 0.002
    lr_warmup_iters: int = 2000
    blur_warmup_iters: int = 12500
    clip_gradient_norm: float = 100.0
    r1: float = 5.0
    eikonal: float = 0.1
    tv: float = 0.5
    entropy: float = 0.05
    path_length_regularization: bool = True
    pl_decay: float = 0.01
    pl_weight: float = 2.0
    supervise_alpha: bool = False
    conditional_pose: bool = True
    white_background: bool = False
    camera_flipped: bool = False
    is_highres: bool = False
    augment_p: float = 0.0
    augment_ada: bool = False
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_rampup: float = 500000.0
    noise_mode: str = "none"  # 'none' (disable_stylegan_noise) or 'random'
    use_sdf: bool = True
    # Conditional and dual-discriminator modes: the generator conditioned
    # on an image (use_encoder) or a class label; a second, unconditional
    # discriminator on a render from an independent pose; the l1/mse
    # variants replace the conditional discriminator by a pixel loss
    # against the blurred conditioning image.
    use_encoder: bool = False
    use_class: bool = False
    dual_discriminator: bool = False
    dual_l1: bool = False
    dual_mse: bool = False


def softplus_gan_loss(logits: torch.Tensor, target_positive: bool) -> torch.Tensor:
    """Non-saturating logistic GAN loss."""
    return torch.mean(F.softplus(-logits if target_positive else logits))


def lr_schedule(target: float, warmup_iters: int) -> Callable[[int], float]:
    """target / 10 at count 0, a linear ramp to target over warmup_iters / 2
    optimizer updates, in f32 as optax evaluates it."""
    start = np.float32(target / 10.0)
    delta = np.float32((target - target / 10.0) / (warmup_iters / 2))
    return lambda count: float(np.minimum(start + delta * np.float32(count),
                                          np.float32(target)))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), scale_by_adam(b1, b2, eps),
    scale_by_learning_rate(schedule)) over a list of parameters, updated
    in place. max_norm None leaves the clip out (optax.adam)."""

    def __init__(self, params: List[torch.nn.Parameter], schedule: Callable[[int], float],
                 b1: float, b2: float, eps: float = 1e-8, max_norm: Optional[float] = None):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.max_norm = b1, b2, eps, max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        if self.max_norm is not None:
            norm = global_norm(grads)
            # optax: scale by max_norm / norm only at norm >= max_norm.
            grads = [torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
                     for g in grads]
        count_inc = self.count + 1
        c1 = np.float32(1.0 - np.float32(self.b1) ** np.float32(count_inc))
        c2 = np.float32(1.0 - np.float32(self.b2) ** np.float32(count_inc))
        lr = self.schedule(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * torch.square(g))
            update = (mu / float(c1)) / (torch.sqrt(nu / float(c2)) + self.eps)
            p.add_(update * -lr)
        self.count = count_inc

    def state_dict(self) -> Dict[str, object]:
        """The count and CPU copies of the moments (a checkpoint's form)."""
        return {"count": self.count, "mu": [t.to("cpu", copy=True) for t in self.mu],
                "nu": [t.to("cpu", copy=True) for t in self.nu]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def make_optimizer(params, config: GANTrainConfig, lr_target: float) -> Optimizer:
    return Optimizer(params, lr_schedule(lr_target, config.lr_warmup_iters), b1=0.0,
                     b2=0.99, eps=1e-8, max_norm=config.clip_gradient_norm)


def _params(module: torch.nn.Module) -> List[torch.nn.Parameter]:
    return list(module.parameters())


@trace.spanned("gan.backward")
def param_grads(loss: torch.Tensor, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not use (the
    noise strengths without StyleGAN noise), as JAX's grad gives, averaged
    over ranks; writes no .grad."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return mesh.all_reduce_mean(
        [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])


@dataclasses.dataclass
class GANState:
    """The train state: G (model), D (disc), the optional second D (disc2,
    dual mode), the EMA generator (ema), their optimizers, the iteration,
    the path-length running average (< 0: not yet set) and the effective
    augmentation probability."""

    model: torch.nn.Module
    disc: Optional[torch.nn.Module]
    ema: torch.nn.Module
    opt_g: Optimizer
    opt_d: Optional[Optimizer]
    ppl_running_avg: torch.Tensor
    augment_p_eff: torch.Tensor
    iteration: int = 0
    disc2: Optional[torch.nn.Module] = None
    opt_d2: Optional[Optimizer] = None

    def state_dict(self) -> Dict[str, object]:
        """Everything a resume needs; 'model_ema' is the EMA generator in
        the reference's state-dict names (utils/weights.py reads it)."""
        def cpu(module):
            return None if module is None else {k: v.detach().cpu()
                                                for k, v in module.state_dict().items()}

        def opt(o):
            return None if o is None else o.state_dict()

        return {"model": cpu(self.model), "model_ema": cpu(self.ema),
                "discriminator": cpu(self.disc), "discriminator2": cpu(self.disc2),
                "optimizer_g": opt(self.opt_g), "optimizer_d": opt(self.opt_d),
                "optimizer_d2": opt(self.opt_d2), "iteration": self.iteration,
                "ppl_running_avg": self.ppl_running_avg.cpu(),
                "augment_p_eff": self.augment_p_eff.cpu()}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        for module, key in ((self.model, "model"), (self.ema, "model_ema"),
                            (self.disc, "discriminator"), (self.disc2, "discriminator2")):
            if module is not None:
                module.load_state_dict(state[key], strict=True)
        for o, key in ((self.opt_g, "optimizer_g"), (self.opt_d, "optimizer_d"),
                       (self.opt_d2, "optimizer_d2")):
            if o is not None:
                o.load_state_dict(state[key])
        self.iteration = int(state["iteration"])
        self.ppl_running_avg.copy_(state["ppl_running_avg"])
        self.augment_p_eff.copy_(state["augment_p_eff"])


def init_gan_state(config: GANTrainConfig, model, disc=None, disc2=None) -> GANState:
    """The state at iteration 0 around an initialized generator and
    discriminators (disc is None in the dual l1/mse modes). The EMA
    generator starts as a copy of the generator."""
    device = next(model.parameters()).device
    ema = copy.deepcopy(model).requires_grad_(False)
    opt_d = None
    if disc is not None and not (config.dual_l1 or config.dual_mse):
        opt_d = make_optimizer(_params(disc), config, config.lr_d)
    else:
        disc = None
    opt_d2 = None
    if config.dual_discriminator:
        opt_d2 = make_optimizer(_params(disc2), config, config.lr_d)
    return GANState(
        model=model, disc=disc, ema=ema,
        opt_g=make_optimizer(_params(model), config, config.lr_g), opt_d=opt_d,
        ppl_running_avg=-torch.ones((), device=device),
        # Fixed-probability augmentation applies from the first iteration;
        # only ADA ramps up from 0.
        augment_p_eff=torch.tensor(0.0 if config.augment_ada else config.augment_p,
                                   dtype=torch.float32, device=device),
        disc2=disc2, opt_d2=opt_d2,
    )


def ema_decay(iteration: int) -> np.float32:
    """Warm-up-accelerated EMA decay. The base decay is 0.5 ** (32 /
    10000), with the reference's fixed 32 whatever the batch size."""
    alpha = 0.5 ** (32.0 / 10000.0)
    if iteration < 1000:
        return np.float32(alpha**100)
    return np.float32(alpha**10 if iteration < 10000 else alpha)


@torch.no_grad()
def update_ema(ema: torch.nn.Module, model: torch.nn.Module, iteration: int) -> None:
    """ema <- ema * a + model * (1 - a) over the parameters (buffers are
    not averaged)."""
    a = ema_decay(iteration)
    a_t = float(a)
    b_t = float(np.float32(1.0) - a)
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(e * a_t + p * b_t)


@torch.no_grad()
def clamp_sdf_params(model, use_sdf: bool) -> None:
    """The post-step clamp of the Laplace (beta, alpha) scalars at 1e-3."""
    if use_sdf:
        model.beta.clamp_(min=1e-3)
        model.alpha.clamp_(min=1e-3)


def _f32(x, device) -> torch.Tensor:
    """x as a 0-dim f32 tensor, filled on the device: torch.tensor(x,
    device=...) would copy it from pageable host memory and wait for the
    device. The same f32 value (x rounded to nearest)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _disc_input(out, config: GANTrainConfig) -> torch.Tensor:
    if config.supervise_alpha:
        return torch.cat((out.rgb, out.mask[..., None]), dim=-1)
    return out.rgb


def _draw(draws: Dict, name: str, make: Callable[[], torch.Tensor]):
    value = draws.get(name)
    return make() if value is None else value


@trace.spanned("gan.augment")
def _augment_camera(config, state, generator, pose, focal, tform):
    _, pose, focal, _ = augment_mod.augment(
        generator, None, pose, focal, state.augment_p_eff, config.white_background,
        tform=tform)
    return pose, focal


@trace.spanned("gan.g_step")
@mesh.sharded_step
def g_step(
    config: GANTrainConfig,
    render_config: RenderConfig,
    state: GANState,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    batch2: Optional[Dict[str, torch.Tensor]] = None,
    draws: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """Generator step (even iterations): updates G, its EMA and the
    path-length average in place and returns the metrics (device scalars).

    batch: {'pose' [B, 4, 4], 'focal' [B] (or absent), 'center', 'bbox'},
    raw camera draws, augmented here; encoder mode adds 'images', class
    mode 'classes'; dual mode takes a second camera draw in `batch2`.
    Gradients are taken with respect to G's parameters only: no .grad is
    written anywhere.
    """
    draws = draws or {}
    model, dev = state.model, state.ppl_running_avg.device
    pose, focal = batch["pose"], batch.get("focal")
    # The pixel-loss branch compares the render with the un-transformed
    # conditioning image, so its camera is not augmented.
    if config.augment_p > 0 and not (config.dual_l1 or config.dual_mse):
        pose, focal = _augment_camera(config, state, generator, pose, focal,
                                      draws.get("tform"))
    cond_image = batch.get("images") if config.use_encoder else None
    cond_rgb = cond_image[..., :3] if cond_image is not None else None
    labels = batch.get("classes") if config.use_class else None

    pose2 = focal2 = None
    if config.dual_discriminator:
        pose2, focal2 = batch2["pose"], batch2.get("focal")
        if config.augment_p > 0:
            pose2, focal2 = _augment_camera(config, state, generator, pose2, focal2,
                                            draws.get("tform2"))

    B = pose.shape[0]
    z = _draw(draws, "z", lambda: mesh.draw(torch.randn, (B, config.latent_dim),
                                              generator=generator, device=dev))
    out, aux = render(render_config, model, pose, focal, z, center=batch.get("center"),
                      bbox=batch.get("bbox"), generator=generator, device=dev,
                      label=labels, image=cond_rgb, noise_mode=config.noise_mode)
    img = _disc_input(out, config)
    if config.dual_l1 or config.dual_mse:
        sigma = filters.blur_schedule_sigma(state.iteration, config.blur_warmup_iters)
        target = filters.blur_dynamic(cond_rgb, sigma, config.white_background)
        diff = img[..., :3] - target
        loss = torch.mean(torch.square(diff) if config.dual_mse else regularizers.abs_jax(diff)) * 10.0
    else:
        with trace.span("gan.disc"):
            logits = state.disc(img, pose, cond_rgb, focal, labels)
            loss = softplus_gan_loss(logits, True)
    metrics = {"loss_g": loss.detach()}

    if config.dual_discriminator:
        loss = loss / 2.0
        out2, _ = render(render_config, model, pose2, focal2, z,
                         center=batch2.get("center"), bbox=batch2.get("bbox"),
                         generator=generator, device=dev, label=labels, image=cond_rgb,
                         noise_mode=config.noise_mode)
        with trace.span("gan.disc"):
            logits2 = state.disc2(_disc_input(out2, config), pose2, None, focal2)
            loss2 = softplus_gan_loss(logits2, True)
        metrics["loss_g_uncond"] = loss2.detach()
        loss = loss + loss2 / 2.0

    with trace.span("gan.regularizers"):
        if "bins" in draws:
            bins, perturb = draws["bins"], draws.get("perturb")
        else:
            bins, perturb = regularizers.volume_samples(model, B, generator, dev)
        regs = regularizers.volume_regularizers(
            model, aux["planes"], bins, perturb, want_eikonal=config.use_sdf,
            want_tv=config.tv > 0, want_entropy=config.entropy > 0)
        warmup_mul = torch.clamp_max(_f32(state.iteration, dev) / config.blur_warmup_iters, 1.0)
        if config.use_sdf:
            eik = torch.mean(regs["sdf_eikonal_loss"])
            loss = loss + config.eikonal * eik
            metrics["loss_eikonal"] = eik.detach()
        if config.tv > 0:
            tv = torch.mean(regs["total_variation_loss"])
            loss = loss + config.tv * warmup_mul * tv
            metrics["loss_tv"] = tv.detach()
        if config.entropy > 0:
            ent = torch.mean(regs["entropy_loss"])
            loss = loss + config.entropy * warmup_mul * ent
            metrics["loss_entropy"] = ent.detach()

        ppl_avg = state.ppl_running_avg
        if config.path_length_regularization:
            ppl = regularizers.path_length(model, aux["ws"], draws.get("ppl_noise"), generator)
            pl_weight = config.pl_weight * torch.clamp_max(
                _f32(state.iteration, dev) / config.lr_warmup_iters, 1.0)
            ppl_mean = mesh.mean(torch.mean(ppl.detach()))  # over the global batch
            ppl_avg = torch.where(state.ppl_running_avg < 0, ppl_mean.detach(),
                                  state.ppl_running_avg)
            # The running-average target is detached: no gradient flows
            # through mean(ppl) into the penalty's target.
            pl_mean = (ppl_avg * (1 - config.pl_decay) + ppl_mean * config.pl_decay).detach()
            ppl_loss = torch.mean(torch.square(ppl - pl_mean))
            loss = loss + pl_weight * ppl_loss
            metrics["loss_ppl"] = ppl_loss.detach()
            ppl_avg = pl_mean

    grads = param_grads(loss, _params(model))
    with trace.span("gan.optimizer"):
        state.opt_g.step(grads)
        clamp_sdf_params(model, config.use_sdf)
        update_ema(state.ema, model, state.iteration)
        metrics["grad_norm_g"] = global_norm(grads).detach()
    state.ppl_running_avg = ppl_avg
    state.iteration += 1
    return mesh.mean_metrics(metrics)


@trace.spanned("gan.augment")
def prepare_real_phase(config, state, batch, generator, tform=None):
    """ADA-augments image and camera together (the high-resolution images,
    pooled back, where the batch has them), then the warm-up blur.
    Returns (image, pose, focal)."""
    real_img = batch["images"]
    pose, focal = batch["pose"], batch.get("focal")
    if config.augment_p > 0:
        src = batch.get("images_highres", real_img)
        img_aug, pose, focal, _ = augment_mod.augment(
            generator, src, pose, focal, state.augment_p_eff, config.white_background,
            tform=tform)
        if "images_highres" in batch:
            # Anti-alias back to the training resolution.
            img_aug = F.avg_pool2d(img_aug.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        real_img = img_aug
    sigma = filters.blur_schedule_sigma(state.iteration, config.blur_warmup_iters)
    real_img = filters.blur_dynamic(real_img, sigma, config.white_background)
    return real_img, pose, focal


@torch.no_grad()
def render_fake_phase(config, render_config, state, batch, generator, z,
                      cond_image=None, labels=None, tform=None):
    """Renders the fake batch with the generator frozen (no gradient, so
    no plane-gradient kernel). Returns (image, pose, focal)."""
    pose, focal = batch["pose"], batch.get("focal")
    if config.augment_p > 0:
        pose, focal = _augment_camera(config, state, generator, pose, focal, tform)
    out, _ = render(render_config, state.model, pose, focal, z,
                    center=batch.get("center"), bbox=batch.get("bbox"),
                    generator=generator, device=z.device, label=labels,
                    image=cond_image, noise_mode=config.noise_mode)
    return _disc_input(out, config), pose, focal


def d_branch(config: GANTrainConfig, disc, real, fake, suffix: str = ""):
    """One discriminator's real + R1 + fake loss: R1 is the squared norm of
    the gradient of the real logits' sum with respect to the real images,
    at every D step. real/fake: (img, pose, focal, cond_img, label).
    Returns (gradients of its parameters, metrics)."""
    real_img, pose_r, focal_r, cond_r, label_r = real
    fake_img, pose_f, focal_f, cond_f, label_f = fake
    real_img = real_img.detach().requires_grad_(config.r1 > 0)
    with trace.span("gan.disc"):
        logits_real = disc(real_img, pose_r, cond_r, focal_r, label_r)
        loss_real = softplus_gan_loss(logits_real, True)
    with trace.span("gan.regularizers"):
        grad_penalty = torch.zeros((), device=real_img.device)
        if config.r1 > 0:
            (g_img,) = torch.autograd.grad(logits_real.sum(), real_img, create_graph=True)
            grad_penalty = torch.mean(torch.sum(
                torch.square(g_img.reshape(g_img.shape[0], -1)), dim=1))
    with trace.span("gan.disc"):
        logits_fake = disc(fake_img, pose_f, cond_f, focal_f, label_f)
        loss_fake = softplus_gan_loss(logits_fake, False)
    loss = loss_real + (config.r1 / 2.0) * grad_penalty + loss_fake
    grads = param_grads(loss, _params(disc))
    metrics = {
        f"loss_d_real{suffix}": loss_real.detach(),
        f"loss_d_fake{suffix}": loss_fake.detach(),
        f"loss_r1{suffix}": grad_penalty.detach(),
        f"sign_real{suffix}": torch.mean(torch.sign(logits_real.detach())),
    }
    return grads, metrics


@trace.spanned("gan.d_step")
@mesh.sharded_step
def d_step(
    config: GANTrainConfig,
    render_config: RenderConfig,
    state: GANState,
    real_batch: Dict[str, torch.Tensor],
    fake_batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    real_batch2: Optional[Dict[str, torch.Tensor]] = None,
    fake_batch2: Optional[Dict[str, torch.Tensor]] = None,
    draws: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """Discriminator step (odd iterations): updates D (and D2), the ADA p
    and the iteration in place; returns the metrics (device scalars).

    real_batch also carries 'images' [B, H, W, nc] (and optionally
    'images_highres'); dual mode takes independent real and fake draws
    for the second discriminator. The second fake phase reuses the first
    one's latents, conditioning and labels and redraws only the poses,
    as the reference does. Draws: 'z', 'tform_real', 'tform_fake',
    'tform_real2', 'tform_fake2'.
    """
    draws = draws or {}
    dev = state.augment_p_eff.device
    metrics: Dict[str, torch.Tensor] = {}
    z = _draw(draws, "z", lambda: mesh.draw(torch.randn,
                                              (fake_batch["pose"].shape[0], config.latent_dim),
                                              generator=generator, device=dev))
    cond_f = (fake_batch["images"][..., :3]
              if (config.use_encoder and "images" in fake_batch) else None)
    label_f = fake_batch.get("classes") if config.use_class else None

    grads = None
    if not (config.dual_l1 or config.dual_mse):
        real_img, pose_r, focal_r = prepare_real_phase(config, state, real_batch, generator,
                                                       draws.get("tform_real"))
        cond_r = real_batch["images"][..., :3] if config.use_encoder else None
        label_r = real_batch.get("classes") if config.use_class else None
        fake_img, pose_f, focal_f = render_fake_phase(
            config, render_config, state, fake_batch, generator, z, cond_f, label_f,
            draws.get("tform_fake"))
        grads, m0 = d_branch(config, state.disc,
                             (real_img, pose_r, focal_r, cond_r, label_r),
                             (fake_img, pose_f, focal_f, cond_f, label_f))
        metrics.update(m0)
        with trace.span("gan.optimizer"):
            metrics["grad_norm_d"] = global_norm(grads).detach()

    grads2 = None
    if config.dual_discriminator:
        rb2 = real_batch2 if real_batch2 is not None else real_batch
        fb2 = fake_batch2 if fake_batch2 is not None else fake_batch
        real_img2, pose_r2, focal_r2 = prepare_real_phase(config, state, rb2, generator,
                                                          draws.get("tform_real2"))
        fake_img2, pose_f2, focal_f2 = render_fake_phase(
            config, render_config, state, fb2, generator, z, cond_f, label_f,
            draws.get("tform_fake2"))
        grads2, m1 = d_branch(config, state.disc2,
                              (real_img2, pose_r2, focal_r2, None, None),
                              (fake_img2, pose_f2, focal_f2, None, None), suffix="_uncond")
        metrics.update(m1)
    # Global losses and ADA's sign before the p update.
    metrics = mesh.mean_metrics(metrics)

    with trace.span("gan.optimizer"):
        if grads is not None and grads2 is not None:
            # One clip over both discriminators' parameters, by their joint
            # norm; each optimizer's own clip is then a no-op.
            joint_norm = global_norm(grads + grads2)
            scale = torch.clamp_max(config.clip_gradient_norm / torch.clamp_min(joint_norm, 1e-12),
                                    1.0)
            grads = [g * scale for g in grads]
            grads2 = [g * scale for g in grads2]
            metrics["grad_norm_d"] = joint_norm.detach()
        if grads is not None:
            state.opt_d.step(grads)
        if grads2 is not None:
            state.opt_d2.step(grads2)

    # ADA adapts on the unconditional discriminator's sign when dual.
    sign_key = "sign_real_uncond" if config.dual_discriminator else "sign_real"
    metrics.setdefault(sign_key, torch.zeros((), device=dev))
    metrics.setdefault("sign_real", metrics[sign_key])

    # The ADA p update, every ada_interval-th D step, held at 0 through
    # the blur warm-up.
    p_eff = state.augment_p_eff
    if config.augment_ada and config.augment_p > 0:
        if state.iteration % (2 * config.ada_interval) == 2 * config.ada_interval - 1:
            step = np.float32(config.batch_size * config.ada_interval / config.ada_rampup)
            delta = torch.sign(metrics[sign_key] - np.float32(config.ada_target)) * float(step)
            new_p = torch.clamp(p_eff + delta, 0.0, float(np.float32(config.augment_p)))
            if state.iteration < config.blur_warmup_iters:
                new_p = torch.zeros_like(new_p)
            p_eff = new_p
    elif config.augment_p > 0:
        p_eff = _f32(config.augment_p, dev)
    state.augment_p_eff = p_eff
    metrics["augment_p"] = p_eff
    state.iteration += 1
    return metrics


@mesh.sharded_step
def sdf_pretrain_step(
    config: GANTrainConfig,
    model,
    opt: Optimizer,
    generator: Optional[torch.Generator] = None,
    cond_image: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    draws: Optional[Dict] = None,
) -> torch.Tensor:
    """One step of unit-sphere SDF pretraining (mapping and synthesis
    fitted to a sphere's distance field, with the eikonal term); updates
    the generator in place through `opt` (optax.adam: make_pretrain_optimizer)
    and returns the loss. Conditional modes pretrain with their
    conditioning. Draws: 'z', 'bins'. On several ranks each takes its
    rows of config.batch_size."""
    draws = draws or {}
    dev = next(model.parameters()).device
    batch = mesh.local_batch(config.batch_size)
    z = _draw(draws, "z", lambda: mesh.draw(torch.randn, (batch, config.latent_dim),
                                              generator=generator, device=dev))
    bins = _draw(draws, "bins", lambda: regularizers.volume_samples(
        model, batch, generator, dev)[0])
    ws = model.mapping(z, labels, cond_image)
    losses = regularizers.sdf_pretrain_losses(model, ws, bins)
    loss = (torch.mean(losses["sdf_distance_loss"])
            + config.eikonal * torch.mean(losses["sdf_eikonal_loss"]))
    opt.step(param_grads(loss, opt.params))
    return mesh.mean(loss.detach())


def make_pretrain_optimizer(model, lr: float) -> Optimizer:
    """optax.adam(lr) over the generator's parameters."""
    return Optimizer(_params(model), lambda count: lr, b1=0.9, b2=0.999, eps=1e-8)
