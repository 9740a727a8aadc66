"""Differentiable volume rendering: coarse -> fine orchestration.

Counterpart of nerf_from_image_tpu/engine/render.py:

  rays -> AABB near/far -> stratified coarse pass -> EG3D weight smoothing
  -> inverse-CDF fine pass -> merge of the two passes -> alpha composite.

The triplanes are synthesized once per render and the field is queried
once per pass. Randomness comes from an explicit torch.Generator;
`generator=None` gives the deterministic render.

With `plane_splat` every field query goes through
kernels/splat.triplane_sample_mean, whose plane gradient is the CUDA
kernel of csrc/splat.cu. As in the JAX package, a query whose points form
whole image rows (the unchunked render, or chunks of whole rows) hands
the op its ray grid and `splat_block`, and the kernel accumulates
ray-coherent blocks on chip; any other query (a padded chunk) hands it
none. The kernel is exact for any point geometry, so unlike the JAX
package no query falls back to another sampler, and the TPU kernel's
window and residual settings have no counterpart.

With `shard_rays` on several ranks (parallel/mesh.py) each rank renders
its contiguous block of the image's rows with the full, replicated
planes, and the maps are assembled by an autograd-aware all-gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from nerf_from_image_tpu_torch.ops import aabb, compositing, rays, sampling
from nerf_from_image_tpu_torch.ops.triplane import pack_corners
from nerf_from_image_tpu_torch.parallel import mesh
from nerf_from_image_tpu_torch.pose.pose import invert_space
from nerf_from_image_tpu_torch.utils import trace
from nerf_from_image_tpu_torch.utils.device import check_on_device, resolve_device


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering configuration: the JAX package's fields but its TPU splat
    settings (`pack_planes`, `splat_window`, `splat_save_rows`)."""

    resolution: int = 128
    depth_samples_per_ray: int = 64
    fine_sampling: bool = True
    scene_range: float = 1.4
    white_background: bool = False
    # Per-ray view-direction embedding (a use_viewdir generator, CARLA).
    use_viewdir: bool = False
    # SDF normal map (Generator.sample_field 'normals'); evaluation only.
    compute_normals: bool = False
    # Semantic class probabilities (a semantic generator's palette).
    compute_semantics: bool = False
    # Canonical coordinate map, returned in the semantics slot (it takes
    # the slot over from compute_semantics).
    compute_coords: bool = False
    # Field queries run in chunks of this many points per batch element,
    # recomputed in the backward (torch.utils.checkpoint); None = one call.
    query_chunk: Optional[int] = 131072
    # Dtype of the gathered plane tables: 'bfloat16', or None for the
    # synthesis dtype (strict f32, the parity mode).
    plane_dtype: Optional[str] = None
    # Convert the ray-distance depth map to z-buffer depth.
    zbuffer_depth: bool = False
    # Triplane sampling through the op with the hand-written splat
    # backward (first-order only) instead of autograd's scatter-add.
    plane_splat: bool = False
    # Ray-coherent blocks of the splat backward: an image tile of th x tw
    # rays by ts consecutive samples.
    splat_block: Tuple[int, int, int] = (16, 16, 4)
    # 'pairwise': sort-free dual-list compositing; 'sort': argsort merge.
    merge_mode: str = "pairwise"
    # Split the image's H rows over the ranks: each renders its block (its
    # draws the global draws' rows) and every rank gets the whole maps
    # from an autograd-aware all-gather. Every rank then takes the same
    # loss, and each replicated leaf's gradient is W times its rows'
    # share: their mean over ranks (mesh.all_reduce_mean) is the whole
    # render's gradient. H must be divisible by the world size.
    shard_rays: bool = False


def prepare_rays(
    config: RenderConfig,
    tform_cam2world: torch.Tensor,
    focal_length: Optional[torch.Tensor],
    center: Optional[torch.Tensor] = None,
    bbox: Optional[torch.Tensor] = None,
    height: Optional[int] = None,
    width: Optional[int] = None,
):
    """Ray bundle [B, H, W, 3] x 2 (normalized directions) + near/far [B, H, W];
    H and W are `height` and `width`, config.resolution where None; with
    `shard_rays` the rank's block of the H rows."""
    h = height or config.resolution
    ray_origins, ray_directions = rays.get_ray_bundle(
        h, width or config.resolution, focal_length, tform_cam2world, bbox, center,
    )
    ray_directions = rays.normalize_directions(ray_directions)
    if config.shard_rays:
        rows = mesh.row_block(h)
        ray_origins, ray_directions = ray_origins[:, rows], ray_directions[:, rows]
    near, far = aabb.compute_near_far_planes(
        ray_origins, ray_directions, config.scene_range
    )
    return ray_origins, ray_directions, near, far


def render_field(
    config: RenderConfig,
    field_fn,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    force_no_cam_grad: bool = False,
    viewdir_embedding: Optional[torch.Tensor] = None,
) -> Tuple[compositing.CompositeOutput, Dict[str, torch.Tensor]]:
    """Renders a radiance field along the given rays.

    field_fn(points [B, N, 3], outputs, splat_grid, viewdir_embedding) ->
    {'sigma': [B, N], 'rgb': [B, N, C], ...}, where splat_grid is None or
    (img_shape, block_shape) of the points' ray grid and
    viewdir_embedding None or per point [B, N, F]: `viewdir_embedding`,
    per ray [B, H * W, F], is expanded over each pass's samples so that
    it chunks with the points. Returns (composite maps [B, H, W, ...],
    aux); with `compute_coords` the coordinate map is in the semantics
    slot.
    """
    B, H, W, _ = ray_origins.shape
    S = config.depth_samples_per_ray

    requests = ("sigma", "rgb")
    if config.compute_normals:
        requests += ("normals",)
    if config.compute_semantics:
        requests += ("semantics",)
    if config.compute_coords:
        requests += ("coords",)

    def query(points):
        flat = points.reshape(B, -1, 3)
        n_points = flat.shape[1]
        s_pass = points.shape[-2]
        row = W * s_pass  # points per image row, ray-major and sample-minor
        emb = None
        if viewdir_embedding is not None:
            emb = viewdir_embedding[:, :, None, :].expand(
                B, H * W, s_pass, viewdir_embedding.shape[-1]
            ).reshape(B, n_points, -1)
        chunk = config.query_chunk
        if chunk and n_points > chunk:
            # Pad to a whole number of chunks so the memory bound holds for
            # any point count; each chunk is recomputed in the backward.
            n_chunks = -(-n_points // chunk)
            pad = n_chunks * chunk - n_points
            # A chunk of whole image rows is itself a ray grid.
            grid = None
            if config.plane_splat and pad == 0 and chunk % row == 0:
                grid = ((chunk // row, W, s_pass), config.splat_block)
            if pad:
                flat = torch.cat((flat, flat.new_zeros(B, pad, 3)), dim=1)
                if emb is not None:
                    emb = torch.cat((emb, emb.new_zeros(B, pad, emb.shape[-1])), dim=1)
            outs = [
                checkpoint(
                    field_fn, flat[:, i * chunk : (i + 1) * chunk], requests, grid,
                    None if emb is None else emb[:, i * chunk : (i + 1) * chunk],
                    use_reentrant=False,
                )
                for i in range(n_chunks)
            ]
            out = {
                k: torch.cat([o[k] for o in outs], dim=1)[:, :n_points]
                for k in outs[0]
            }
        else:
            grid = ((H, W, s_pass), config.splat_block) if config.plane_splat else None
            out = field_fn(flat, requests, grid, emb)
        return {
            k: v.reshape(B, H, W, s_pass) if k == "sigma"
            else v.reshape(B, H, W, s_pass, -1)
            for k, v in out.items()
        }

    with trace.span("render.coarse"):
        query_points, depth_values = sampling.compute_query_points_from_rays(
            ray_origins, ray_directions, near, far, S, generator=generator
        )
        if force_no_cam_grad:
            query_points = query_points.detach()
            depth_values = depth_values.detach()
            ray_directions = ray_directions.detach()
        coarse = query(query_points)
    sigma = coarse["sigma"]
    channels = _channels(coarse)

    def fine_pass(sort_fine: bool):
        """EG3D-smoothed importance sampling + fine query."""
        weights = compositing.render_volume_density_weights_only(
            sigma, ray_directions, depth_values
        )
        flat_w = compositing.smooth_weights(weights.reshape(-1, S))
        z_mid = 0.5 * (depth_values[..., 1:] + depth_values[..., :-1])
        # Per ray [B, H, W, ...], so that a ray-sharded render's draws
        # split along H.
        z_samples = sampling.sample_pdf(
            z_mid.detach(),
            flat_w[..., 1:-1].reshape(B, H, W, S - 2),
            S,
            generator=generator,
        )
        if sort_fine and generator is not None:
            # Random quantiles are unordered; the dual-list compositor needs
            # each list sorted. Deterministic quantiles already increase.
            z_samples = torch.sort(z_samples, dim=-1).values
        z_samples = z_samples.detach()
        fine_points = (
            ray_origins[..., None, :]
            + ray_directions[..., None, :] * z_samples[..., :, None]
        )
        return z_samples, query(fine_points)

    if config.fine_sampling and config.merge_mode == "pairwise":
        with trace.span("render.fine"):
            z_samples, fine = fine_pass(sort_fine=True)
        with trace.span("render.composite"):
            out = compositing.composite_dual(
                sigma, depth_values, channels,
                fine["sigma"], z_samples, _channels(fine),
                ray_directions, white_background=config.white_background,
            )
        return out, {"depth_values": depth_values}

    if config.fine_sampling:
        if config.merge_mode != "sort":
            raise ValueError(f"unknown merge_mode {config.merge_mode!r}")
        with trace.span("render.fine"):
            z_samples, fine = fine_pass(sort_fine=False)

    with trace.span("render.composite"):
        if config.fine_sampling:
            # Depth-sorted merge of coarse + fine (stable: ties keep coarse first).
            all_depths = torch.cat((depth_values, z_samples), dim=-1)
            order = torch.argsort(all_depths, dim=-1, stable=True)
            depth_values = torch.take_along_dim(all_depths, order, dim=-1)
            sigma = torch.take_along_dim(
                torch.cat((sigma, fine["sigma"]), dim=-1), order, dim=-1
            )
            fine_channels = _channels(fine)
            channels = {
                k: torch.take_along_dim(torch.cat((v, fine_channels[k]), dim=-2),
                                        order[..., None], dim=-2)
                for k, v in channels.items()
            }

        out = compositing.render_volume_density(
            sigma, channels["rgb"], ray_directions, depth_values,
            channels.get("normals"), channels.get("semantics"),
            white_background=config.white_background,
        )
    return out, {"depth_values": depth_values}


def _channels(field: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The per-sample channels of a field query for compositing; the
    coordinates take the semantics slot, as in the reference."""
    channels = {k: v for k, v in field.items() if k != "sigma"}
    if "coords" in channels:
        channels["semantics"] = channels.pop("coords")
    return channels


def make_field_fn(model, planes, attention_values=None, splat: bool = False,
                  table_dtype: Optional[str] = None):
    """Binds Generator.sample_field over fixed planes:
    field_fn(points [B, N, 3], outputs, splat_grid=None,
    viewdir_embedding=None) -> dict of field values."""

    def field_fn(points, outputs, splat_grid=None, viewdir_embedding=None):
        return model.sample_field(
            planes, points, attention_values=attention_values,
            viewdir_embedding=viewdir_embedding, outputs=outputs, splat=splat,
            table_dtype=table_dtype, splat_grid=splat_grid,
        )

    return field_fn


def render(
    config: RenderConfig,
    model,
    tform_cam2world: torch.Tensor,
    focal_length: Optional[torch.Tensor],
    latent: torch.Tensor,
    center: Optional[torch.Tensor] = None,
    bbox: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    force_no_cam_grad: bool = False,
    device="cuda",
    label: Optional[torch.Tensor] = None,
    image: Optional[torch.Tensor] = None,
    noise_mode: str = "none",
    height: Optional[int] = None,
    width: Optional[int] = None,
) -> Tuple[compositing.CompositeOutput, Dict[str, Any]]:
    """Full render from latents and camera.

    `latent`: [B, z_dim] goes through the mapping network, with the class
    `label` [B] or conditioning `image` [B, H, W, 3] of a conditional
    generator; [B, 1, w_dim] is broadcast to every layer; [B, num_ws,
    w_dim] is used as it is. `noise_mode` ('none', 'const' or 'random',
    drawn from `generator`) is the synthesis network's StyleGAN noise.
    The image is `height` x `width` rays (config.resolution where None).
    Every tensor must lie on `device` ('cuda' by default, which needs a
    card; 'cpu' runs the kernels' plain versions).
    """
    dev = resolve_device(device)
    check_on_device(dev, tform_cam2world=tform_cam2world,
                    focal_length=focal_length, latent=latent, center=center,
                    bbox=bbox, label=label, image=image)
    with trace.span("render.synthesis"):
        ray_origins, ray_directions, near, far = prepare_rays(
            config, tform_cam2world, focal_length, center, bbox, height, width
        )

        if latent.dim() == 3:
            ws = latent
            if latent.shape[1] == 1:
                ws = latent.expand(latent.shape[0], model.num_ws, latent.shape[2])
        else:
            ws = model.mapping(latent, label, image)

        planes = model.synthesize(ws, noise_mode, generator)
        if config.plane_splat:
            # The splat op casts and corner-packs the raw planes itself, so its
            # backward returns unpacked plane gradients directly.
            field_planes = planes
        else:
            field_planes = planes
            if config.plane_dtype is not None:
                field_planes = field_planes.to(getattr(torch, config.plane_dtype))
            field_planes = pack_corners(field_planes)

        attention_values = model.texture(ws) if model.attention_values > 0 else None

        viewdir_embedding = None
        if config.use_viewdir:
            # force_no_cam_grad detaches the view directions too (the
            # reference detaches ray_directions before building them).
            B, H, W, _ = ray_directions.shape
            dirs = ray_directions.detach() if force_no_cam_grad else ray_directions
            viewdir_embedding = model.viewdir_embedding(dirs.reshape(B, H * W, 1, 3))[:, :, 0, :]

        field_fn = make_field_fn(
            model, field_planes, attention_values, splat=config.plane_splat,
            table_dtype=config.plane_dtype,
        )

    with mesh.sharded_draws(1) if config.shard_rays else contextlib.nullcontext():
        out, aux = render_field(
            config, field_fn, ray_origins, ray_directions, near, far,
            generator=generator, force_no_cam_grad=force_no_cam_grad,
            viewdir_embedding=viewdir_embedding,
        )
    if config.zbuffer_depth:
        w2c = invert_space(tform_cam2world)
        view_dirs = torch.sum(
            ray_directions[..., None, :] * w2c[:, None, None, :3, :3], dim=-1
        )
        out = out._replace(depth=-(view_dirs[..., -1] * out.depth))
    if config.shard_rays:
        # aux['depth_values'] stays the rank's rows.
        out = out._replace(**{k: mesh.all_gather_rows(v, dim=1)
                              for k, v in out._asdict().items() if v is not None})
    aux["ws"] = ws
    aux["planes"] = planes
    if attention_values is not None:
        aux["attention_values"] = attention_values
    return out, aux
