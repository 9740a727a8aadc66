"""Pose-conditioned StyleGAN2 discriminator.

Counterpart of nerf_from_image_tpu/models/discriminator.py: the
conditioning vector concatenates an optional class embedding or image
embedding (ResidualEncoder) with the 13-dim pose encoding (z0, t2, s, R
flattened; pose.matrix_to_conditioning_vector), and feeds the projection
of a StyleGAN2 backbone. Attribute names are the reference state-dict keys.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from port_bench.reference.models.generator import ResidualEncoder
from port_bench.reference.models.stylegan import DiscriminatorBackbone
from port_bench.reference.pose.pose import matrix_to_conditioning_vector
from port_bench.reference.utils.device import resolve_device


class Discriminator(nn.Module):
    """x [B, R, R, nc] images in [-1, 1], pose [B, 4, 4] cam2world, focal
    [B] or None, image [B, H, W, 3] (use_encoder), label [B] (num_classes)
    -> logits [B, 1].

    Parameters are drawn from `generator` (a CPU torch.Generator; None
    means seed 0): weights N(0, 1), biases 0, then moved to `device`.
    """

    def __init__(self, resolution, nc, camera_flipped, conditional_pose=True,
                 use_encoder=False, num_classes: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.camera_flipped = camera_flipped
        self.conditional_pose = conditional_pose
        self.use_encoder = use_encoder
        self.num_classes = num_classes
        c_dim = 0
        if num_classes:
            self.label_embedding = nn.Embedding(num_classes, 512)
            c_dim += 512
        elif use_encoder:
            self.emb = ResidualEncoder(3, 256)
        if use_encoder:
            c_dim += 512
        if conditional_pose:
            c_dim += 13
        self.backbone = DiscriminatorBackbone(c_dim, resolution, nc)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if hasattr(m, "init_parameters"):
                m.init_parameters(generator)
        if num_classes:
            with torch.no_grad():
                self.label_embedding.weight.normal_(generator=generator)
        self.to(dev)

    def forward(self, x, pose=None, image=None, focal=None, label=None):
        cond = []
        if self.num_classes:
            cond.append(self.label_embedding(label))
        elif self.use_encoder:
            cond.append(self.emb(image))
        if self.conditional_pose:
            cond.append(matrix_to_conditioning_vector(pose, focal, self.camera_flipped))
        return self.backbone(x, torch.cat(cond, dim=-1) if cond else None)
