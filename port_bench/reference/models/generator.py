"""Triplane SDF radiance-field generator with a StyleGAN2 backbone.

Counterpart of nerf_from_image_tpu/models/generator.py: mapping
(unconditional, or conditioned on a class label or on an image through
ResidualEncoder), synthesis, texture palette and field queries, with SDF
normals and the view-direction branch (CARLA). The decoder samples the
planes through the splat op (first-order only), corner-packed tables, or
the raw planes through ops/grid_sample.py, which autograd differentiates
to any order: the double-backward regularizers decode there. Attribute
names are the reference state-dict keys.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.models.layers import (
    ConditionalLayerNorm,
    EqualizedConv2d,
    EqualizedLinear,
    LayerNormAffine,
    leaky_relu,
)
from port_bench.reference.models.stylegan import (
    MappingNetwork,
    SynthesisNetwork,
)
from port_bench.reference.ops.grid_sample import grid_sample_2d
from port_bench.reference.ops.triplane import plane_coords, sample_packed
from port_bench.reference.utils.device import resolve_device

_INV_SQRT2 = math.sqrt(2.0) / 2.0


def laplace_pdf(x, beta):
    return 0.5 * torch.exp(-torch.abs(x) / beta) / beta


def laplace_cdf(x, beta):
    return 0.5 + 0.5 * torch.sign(x) * (1.0 - torch.exp(-torch.abs(x) / beta))


def wide_sigmoid_rescaled(x):
    """MipNeRF wide sigmoid rescaled to [-1.002, 1.002]."""
    return torch.sigmoid(x) * 2.004 - 1.002


class _InstanceNormAffine(nn.Module):
    """Per-channel affine of an instance norm (reference names weight,
    bias); the normalization itself is in ResidualEncoder."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))


class ResidualEncoder(nn.Module):
    """Image [B, H, W, nc] (NHWC) -> pooled feature vector [B, 512]: the
    conditional generator's and the discriminator's image embedding.

    With use_instance_norm the residual convs drop their bias and are
    followed by an affine instance norm (eps 1e-5). `nd` is the
    reference's argument; the pooled width is 512 whatever it is.
    """

    def __init__(self, nc, nd, use_instance_norm=False):
        super().__init__()
        self.use_instance_norm = use_instance_norm
        bias_mid = not use_instance_norm
        self.conv1 = EqualizedConv2d(nc, 64, 3)
        self.conv2 = EqualizedConv2d(64, 128, 3)
        self.conv3 = EqualizedConv2d(128, 128, 3, use_bias=bias_mid)
        self.conv4 = EqualizedConv2d(128, 128, 3, use_bias=bias_mid)
        self.shortcut = EqualizedConv2d(128, 256, 1, use_bias=False)
        self.conv5 = EqualizedConv2d(128, 256, 3, use_bias=bias_mid)
        self.conv6 = EqualizedConv2d(256, 256, 3, use_bias=bias_mid)
        self.conv7 = EqualizedConv2d(256, 256, 3, use_bias=bias_mid)
        self.conv8 = EqualizedConv2d(256, 256, 3, use_bias=bias_mid)
        self.conv9 = EqualizedConv2d(256, 512, 3)
        self.conv10 = EqualizedConv2d(512, 512, 3)
        if use_instance_norm:
            for i, ch in zip(range(3, 9), (128, 128, 256, 256, 256, 256)):
                self.add_module(f"norm{i}", _InstanceNormAffine(ch))

    def _norm(self, h, i):
        if not self.use_instance_norm:
            return h
        mean = torch.mean(h, dim=(2, 3), keepdim=True)
        var = torch.var(h, dim=(2, 3), keepdim=True, unbiased=False)
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        norm = getattr(self, f"norm{i}")
        return h * norm.weight.reshape(1, -1, 1, 1) + norm.bias.reshape(1, -1, 1, 1)

    def _conv_norm(self, h, i):
        return leaky_relu(self._norm(getattr(self, f"conv{i}")(h), i))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = leaky_relu(self.conv1(x))
        x = leaky_relu(self.conv2(x))
        x = F.avg_pool2d(x, 2)

        s = x
        x = self._conv_norm(self._conv_norm(x, 3), 4)
        x = F.avg_pool2d(x + s, 2) * _INV_SQRT2

        s = self.shortcut(x)
        x = self._conv_norm(self._conv_norm(x, 5), 6)
        x = F.avg_pool2d(x + s, 2) * _INV_SQRT2

        s = x
        x = self._conv_norm(self._conv_norm(x, 7), 8)
        x = F.avg_pool2d(x + s, 2) * _INV_SQRT2

        x = leaky_relu(self.conv9(x))
        x = leaky_relu(self.conv10(x))
        return torch.mean(x, dim=(2, 3))


class AttentionMapper(nn.Module):
    """Latent -> RGB palette of `num_values` colors (texture attention)."""

    def __init__(self, latent_dim, num_values, hidden_size=512):
        super().__init__()
        self.num_values = num_values
        self.hidden_size = hidden_size
        self.const = nn.Parameter(torch.empty(1, hidden_size))
        for i in range(1, 5):
            self.add_module(
                f"fc{i}", EqualizedLinear(hidden_size, hidden_size, use_bias=False)
            )
            self.add_module(f"norm{i}", ConditionalLayerNorm(hidden_size, latent_dim))
        self.fc5 = EqualizedLinear(hidden_size, hidden_size)
        self.fc_values = EqualizedLinear(hidden_size, num_values * 3)

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.const.normal_(generator=generator)

    def forward(self, c):
        x = self.const.expand(c.shape[0], self.hidden_size)
        for i in (1, 3):
            shortcut = x
            x = leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"fc{i}")(x), c))
            x = leaky_relu(
                getattr(self, f"norm{i + 1}")(getattr(self, f"fc{i + 1}")(x), c)
            )
            x = (x + shortcut) * _INV_SQRT2
        x = leaky_relu(self.fc5(x))
        values = self.fc_values(x)
        return wide_sigmoid_rescaled(values.reshape(-1, self.num_values, 3))


class ViewDirOutput(nn.Module):
    """The zero-initialized output projection of the view-direction branch:
    features [..., num_features] -> [..., output_size]."""

    def __init__(self, num_features, output_size):
        super().__init__()
        self.num_features = num_features
        self.weight = nn.Parameter(torch.zeros(output_size, num_features))
        self.bias = nn.Parameter(torch.zeros(output_size))

    def forward(self, x):
        weight_gain = 1.0 / math.sqrt(self.num_features)
        return x @ (self.weight * weight_gain).T + self.bias


class ViewDirectionMapper(nn.Module):
    """View direction [..., 3] -> a feature-space embedding [...,
    num_features] (CARLA view dependence). `output` is the projection
    that Generator.color_from_features applies after adding the embedding
    to the decoder's features (the reference's viewdir_mapper.output)."""

    def __init__(self, output_size, num_features=32, hidden_size=64):
        super().__init__()
        self.fc0 = EqualizedLinear(3, hidden_size)
        for i in range(1, 5):
            self.add_module(
                f"fc{i}", EqualizedLinear(hidden_size, hidden_size, use_bias=False)
            )
            self.add_module(f"norm{i}", LayerNormAffine(hidden_size))
        self.fc5 = EqualizedLinear(hidden_size, hidden_size)
        self.fc6 = EqualizedLinear(hidden_size, num_features)
        self.output = ViewDirOutput(num_features, output_size)

    def forward(self, viewdir):
        x = leaky_relu(self.fc0(viewdir))
        for i in (1, 3):
            shortcut = x
            x = leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"fc{i}")(x)))
            x = leaky_relu(
                getattr(self, f"norm{i + 1}")(getattr(self, f"fc{i + 1}")(x))
            )
            x = (x + shortcut) * _INV_SQRT2
        x = leaky_relu(self.fc5(x))
        return self.fc6(x)


class TriplanarDecoder(nn.Module):
    """Bilinear triplane sampling + 2-layer softplus MLP.

    Returns (density_or_distance [B, N, 1], features [B, N, F]).
    """

    def __init__(self, num_input_features, num_output_features, hidden_dim=64):
        super().__init__()
        self.num_input_features = num_input_features
        # Indices 0 and 2 are the reference's net.0 / net.2 keys.
        self.net = nn.ModuleList([
            EqualizedLinear(num_input_features, hidden_dim),
            nn.Softplus(),
            EqualizedLinear(hidden_dim, 1 + num_output_features),
        ])

    def forward(self, planes, coords, splat: bool = False,
                table_dtype: Optional[str] = None, splat_grid=None):
        """planes: raw [B, 3, H, W, C] with splat=True (the splat op casts
        to table_dtype and packs itself), corner-packed [B, 3, H, W, 4C],
        or raw without splat (bilinear grid sampling, differentiable to
        any order); coords: [B, N, 3] in [-1, 1]; splat_grid: None or
        (img_shape, block_shape) of the points' ray grid for the splat
        backward (kernels/splat.triplane_sample_mean)."""
        C = self.num_input_features
        if splat:
            raise ValueError("the reference has no splat op: render with plane_splat=False")
        if planes.shape[-1] == 4 * C:
            c_xy, c_xz, c_yz = plane_coords(coords)
            e1 = sample_packed(planes[:, 0], c_xy)
            e2 = sample_packed(planes[:, 1], c_xz)
            e3 = sample_packed(planes[:, 2], c_yz)
            x = (e1 + e2 + e3) / 3.0
            mlp_dtype = torch.bfloat16 if planes.dtype == torch.bfloat16 else None
        elif planes.shape[-1] == C:
            c_xy, c_xz, c_yz = plane_coords(coords)
            e1 = grid_sample_2d(planes[:, 0], c_xy)
            e2 = grid_sample_2d(planes[:, 1], c_xz)
            e3 = grid_sample_2d(planes[:, 2], c_yz)
            x = (e1 + e2 + e3) / 3.0
            mlp_dtype = torch.bfloat16 if planes.dtype == torch.bfloat16 else None
        else:
            raise ValueError(f"planes of {planes.shape[-1]} channels, expected "
                             f"{C} (raw) or {4 * C} (corner-packed)")
        # bf16 tables keep the [N, hidden] MLP intermediates in bf16 too
        # (parameters stay f32); only the head output is cast back.
        x = self.net[0](x, mlp_dtype)
        x = F.softplus(x)
        x = self.net[2](x, mlp_dtype)
        x = x.to(coords.dtype)
        return x[..., :1], x[..., 1:]


class _Mapping(nn.Module):
    """Holds the mapping backbone under the reference's key prefix
    `mapping_network.backbone.`."""

    def __init__(self, backbone: MappingNetwork):
        super().__init__()
        self.backbone = backbone

    def forward(self, z, c=None):
        return self.backbone(z, c)


class Generator(nn.Module):
    """Top-level generator:

      mapping(z, label, image) -> ws              [B, num_ws, w_dim]
      synthesize(ws) -> planes                    [B, 3, R, R, C]
      texture(ws) -> attention palette            [B, K, 3]
      sample_field(planes, points, ...)           field queries

    Parameters are drawn from `generator` (a CPU torch.Generator; None
    means seed 0) and then moved to `device`.
    """

    def __init__(self, latent_dim, scene_range, attention_values=0,
                 use_viewdir=False, use_sdf=True, w_dim=512, plane_channels=32,
                 synthesis_resolution=256, channel_base=32768, channel_max=512,
                 use_encoder=False, num_classes: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.latent_dim = latent_dim
        self.scene_range = scene_range
        self.attention_values = attention_values
        self.use_viewdir = use_viewdir
        self.use_sdf = use_sdf
        self.w_dim = w_dim
        self.plane_channels = plane_channels
        self.synthesis_resolution = synthesis_resolution
        self.use_encoder = use_encoder
        self.num_classes = num_classes

        # Conditioning: a class embedding, or an image through the
        # encoder (whose pooled width is 512 whatever w_dim is).
        c_dim = 512 if (num_classes or use_encoder) else 0
        if use_encoder:
            self.emb = ResidualEncoder(3, w_dim, use_instance_norm=True)
        self.mapping_network = _Mapping(MappingNetwork(
            z_dim=latent_dim, w_dim=w_dim, num_ws=self.num_ws, num_layers=2,
            lr_multiplier=0.01, c_dim=c_dim, normalize_c=False,
        ))
        self.synthesis_network = SynthesisNetwork(
            w_dim=w_dim, img_resolution=synthesis_resolution,
            img_channels=3 * plane_channels, channel_base=channel_base,
            channel_max=channel_max, use_noise=True,
        )
        output_dim = attention_values if attention_values > 0 else 3
        # With view directions the decoder emits 32 features and the
        # branch's zero-initialized output projects them to the palette.
        decoder_output_dim = 32 if use_viewdir else output_dim
        self.decoder = TriplanarDecoder(plane_channels, decoder_output_dim)
        if use_viewdir:
            self.viewdir_mapper = ViewDirectionMapper(output_dim)
        if use_sdf:
            self.beta = nn.Parameter(torch.empty(1))
            self.alpha = nn.Parameter(torch.empty(1))
        if attention_values > 0:
            self.texture_mapper = AttentionMapper(w_dim, attention_values)
        if num_classes:
            self.class_embedding = nn.Embedding(num_classes, 512)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if m is not self and hasattr(m, "init_parameters"):
                m.init_parameters(generator)
        if num_classes:
            with torch.no_grad():
                self.class_embedding.weight.normal_(generator=generator)
        if use_sdf:
            with torch.no_grad():
                self.beta.fill_(0.1)
                self.alpha.fill_(1.0)
        self.to(dev)

    @property
    def num_synthesis_ws(self) -> int:
        n_levels = int(math.log2(self.synthesis_resolution)) - 1
        return 2 * n_levels - 1 + 1  # 1 conv at 4x4, 2 per level after, +torgb

    @property
    def num_ws(self) -> int:
        return self.num_synthesis_ws + (1 if self.attention_values > 0 else 0)

    # ---- latent pipeline -------------------------------------------------

    def mapping(self, z, label=None, image=None):
        """z [B, latent] (+ class labels [B] or a conditioning image
        [B, H, W, 3]) -> ws [B, num_ws, w_dim]."""
        c = None
        if self.use_encoder:
            if image is None:
                raise ValueError("an encoder-conditioned generator needs `image`")
            c = self.emb(image)
        elif self.num_classes:
            if label is None:
                raise ValueError("a class-conditional generator needs `label`")
            c = self.class_embedding(label)
        return self.mapping_network(z, c)

    def average_w(self, generator: Optional[torch.Generator] = None,
                  n_samples: int = 10000, label=None):
        """Mean w over latents drawn from `generator` (on the model's
        device; None means a seed-0 generator). Unconditional: n_samples
        latents -> [1, num_ws, w_dim]. Class-conditional: `label` [B],
        min(n_samples, 256) latents a label -> [B, num_ws, w_dim]."""
        device = next(self.parameters()).device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if label is None:
            z = torch.randn((n_samples, self.latent_dim), generator=generator,
                            device=device)
            return torch.mean(self.mapping_network(z), dim=0, keepdim=True)
        if not self.num_classes:
            raise ValueError("label given but the generator is unconditional")
        n = min(n_samples, 256)
        B = label.shape[0]
        z = torch.randn((B * n, self.latent_dim), generator=generator, device=device)
        w = self.mapping_network(z, self.class_embedding(torch.repeat_interleave(label, n)))
        return torch.mean(w.reshape((B, n) + w.shape[1:]), dim=1)

    # ---- synthesis -------------------------------------------------------

    def synthesize(self, ws, noise_mode: str = "none", generator=None):
        """ws [B, num_ws, w_dim] -> triplanes [B, 3, R, R, C]."""
        w_synthesis = (
            ws[:, : self.num_synthesis_ws] if self.attention_values > 0 else ws
        )
        img = self.synthesis_network(w_synthesis, noise_mode, generator)
        B, H, W, _ = img.shape
        planes = img.reshape(B, H, W, 3, self.plane_channels)
        return planes.permute(0, 3, 1, 2, 4).contiguous()

    def texture(self, ws):
        """Last (texture) w -> attention palette (attention_values > 0)."""
        assert self.attention_values > 0
        return self.texture_mapper(ws[:, self.num_synthesis_ws])

    def viewdir_embedding(self, viewdirs):
        """View directions [..., 3] -> their embedding [..., 32]
        (use_viewdir only)."""
        if not self.use_viewdir:
            raise ValueError("this generator has no view-direction branch")
        return self.viewdir_mapper(viewdirs)

    # ---- field queries ---------------------------------------------------

    def decode(self, planes, coords):
        """Raw-plane decode at normalized coords [B, N, 3] through the
        grid-sample branch (differentiable to any order) -> (density or
        distance [B, N, 1], features [B, N, F])."""
        return self.decoder(planes, coords)

    def density_from_distance(self, density_or_distance, out_of_box_mask):
        """SDF (or raw) decoder output -> volume density sigma [B, N]."""
        if self.use_sdf:
            beta = self.beta[0]
            alpha = 1.0 / self.alpha[0]
            neg_distance = -density_or_distance[..., -1]
            density_prealpha = laplace_cdf(neg_distance, beta) * (
                1.0 - out_of_box_mask
            )
            return alpha * density_prealpha
        density_pre = density_or_distance[..., -1] - 1.0
        return F.softplus(density_pre) * (1.0 - out_of_box_mask)

    def color_from_features(self, features, attention_values=None,
                            viewdir_embedding=None, want_semantics=False):
        """Decoder features [B, N, F] -> (rgb, semantics probs or None).

        A view-direction generator needs `viewdir_embedding`, per point
        [B, N, 32]: the features become output(leaky_relu(embedding +
        features)).
        """
        if self.use_viewdir:
            if viewdir_embedding is None or viewdir_embedding.shape[:-1] != features.shape[:-1]:
                raise ValueError("a view-direction generator needs the per-point "
                                 "viewdir embedding [B, N, F] (RenderConfig.use_viewdir)")
            features = self.viewdir_mapper.output(
                leaky_relu(viewdir_embedding + features))
        semantics = None
        if self.attention_values == 0:
            rgb = wide_sigmoid_rescaled(features)
        else:
            probs = torch.softmax(features, dim=-1)
            if want_semantics:
                semantics = probs
            # probs [B, N, K] @ palette [B, K, 3], written as three
            # broadcast dot products: as a batched matmul with N ~ 1M rows
            # and K = 10 it takes cuBLAS tens of ms on the card.
            rgb = torch.stack(
                [torch.sum(probs * attention_values[:, None, :, c], dim=-1)
                 for c in range(attention_values.shape[-1])],
                dim=-1,
            )
        return rgb, semantics

    def sample_field(
        self,
        planes,
        points,
        attention_values=None,
        viewdir_embedding=None,
        outputs: Sequence[str] = ("sigma", "rgb"),
        splat: bool = False,
        table_dtype: Optional[str] = None,
        splat_grid=None,
    ) -> Dict[str, torch.Tensor]:
        """Queries the radiance field at world-space points [B, N, 3].

        outputs: subset of {'sigma', 'rgb', 'normals', 'semantics',
        'coords', 'sdf_distance'}. Out-of-box points get zero density.
        viewdir_embedding: per point [B, N, 32], for use_viewdir.
        splat_grid: (img_shape, block_shape) of the points' ray grid, for
        splat=True.

        'normals' are the normalized gradient of the SDF with respect to
        the points, an evaluation output: one decode of detached planes
        at points that require grad, and torch.autograd.grad of the
        distance, which also gives the field values. With detached planes
        the splat op's backward computes the coordinate gradient only, so
        a normals render launches no plane-gradient kernel. Nothing is
        differentiable through them: asked for with grad mode on and
        planes or points that require grad, they raise.
        """
        for o in outputs:
            assert o in ("sigma", "rgb", "normals", "semantics", "coords",
                         "sdf_distance"), o
        res: Dict[str, torch.Tensor] = {}
        coords = points / self.scene_range
        out_of_box = (
            torch.any(torch.abs(coords) > 1.0, dim=-1).to(coords.dtype).detach()
        )
        if "normals" in outputs:
            if not self.use_sdf:
                raise ValueError("normals need an SDF generator (use_sdf=True)")
            if torch.is_grad_enabled() and (planes.requires_grad or points.requires_grad):
                raise ValueError("normals are an evaluation output: render them under "
                                 "torch.no_grad() or with inputs that require no grad")
            with torch.enable_grad():
                pts = points.detach().requires_grad_(True)
                decoded = self.decoder(planes.detach(), pts / self.scene_range,
                                       splat, table_dtype, splat_grid)
                (grad,) = torch.autograd.grad(decoded[0][..., -1].sum(), pts)
            norm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
            res["normals"] = grad / torch.clamp_min(norm, 1e-12)
            decoded = tuple(t.detach() for t in decoded)
        else:
            decoded = self.decoder(planes, coords, splat, table_dtype, splat_grid)
        density_or_distance, features = decoded
        if "sdf_distance" in outputs:
            res["sdf_distance"] = density_or_distance
        if "sigma" in outputs:
            res["sigma"] = self.density_from_distance(density_or_distance, out_of_box)
        if "coords" in outputs:
            res["coords"] = points
        if "rgb" in outputs or "semantics" in outputs:
            rgb, semantics = self.color_from_features(
                features, attention_values, viewdir_embedding,
                want_semantics="semantics" in outputs,
            )
            if "rgb" in outputs:
                res["rgb"] = rgb
            if "semantics" in outputs:
                assert self.attention_values > 0
                res["semantics"] = semantics
        return res
