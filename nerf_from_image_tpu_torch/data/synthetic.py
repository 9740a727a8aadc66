"""Procedural synthetic dataset for tests and benchmarks (no external data).

Generates random camera orbits around the scene box plus flat-colored-sphere
renders; matches the DatasetSplit contract of the real loaders so every
engine path (GAN training, encoder training, inversion, eval) can run
end-to-end in CI. This package's copy of the JAX package's
data/synthetic.py: the same seed gives the same arrays, bit for bit."""

from __future__ import annotations

import numpy as np

from nerf_from_image_tpu_torch.data.splits import DatasetSplit


def random_orbit_poses(rng, n, radius=3.0, flipped=False):
    mats = []
    for _ in range(n):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(-0.4, 0.4)
        eye = radius * np.array(
            [
                np.cos(phi) * np.cos(theta),
                np.cos(phi) * np.sin(theta),
                np.sin(phi),
            ]
        )
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = up
        m[:3, 2] = -forward  # camera looks down -z
        m[:3, 3] = eye
        if flipped:
            m[:3, 1:3] *= -1
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def make_synthetic_split(
    n_images: int = 64,
    resolution: int = 32,
    seed: int = 0,
    white_background: bool = True,
    with_mask_channel: bool = False,
) -> DatasetSplit:
    rng = np.random.RandomState(seed)
    poses = random_orbit_poses(rng, n_images)
    focal = (1.0 + rng.rand(n_images)).astype(np.float32)

    # Flat-shaded sphere images (enough structure for smoke training).
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, resolution), np.linspace(-1, 1, resolution),
        indexing="ij",
    )
    images = []
    for i in range(n_images):
        r2 = xx**2 + yy**2
        mask = (r2 < rng.uniform(0.3, 0.8)).astype(np.float32)
        color = rng.uniform(-1, 1, (3,)).astype(np.float32)
        img = np.ones((resolution, resolution, 3), np.float32)
        if not white_background:
            img *= 0
        img = img * (1 - mask[..., None]) + color * mask[..., None]
        if with_mask_channel:
            img = np.concatenate((img, mask[..., None]), axis=-1)
        images.append(img)
    # Class labels (2 classes by sphere size) so --use_class paths can
    # smoke-train without external data (the reference's class-conditional
    # dataset is CUB, data/datasets.py:412-571).
    classes = (rng.rand(n_images) < 0.5).astype(np.int64)
    return DatasetSplit(
        images=np.stack(images),
        tform_cam2world=poses,
        focal_length=focal,
        classes=classes,
        num_classes=2,
    )
