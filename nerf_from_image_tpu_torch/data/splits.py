"""In-memory dataset splits and evaluation-index machinery.

Re-design of the reference's whole-dataset-in-RAM tensor store
(reference: data/loaders.py:152-194 DatasetSplit) plus the FID/eval index
computation from the engine preamble (reference: run.py:441-516): eval
subset selection (<= 8000 images, matching the Pix2NeRF protocol), the
novel-view permutation pairing each eval image with another view of the
same object, and the fixed z_fid latent draws.

Arrays are host numpy; the drivers move selected batches to the device.
This package's copy of the JAX package's data/splits.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DatasetSplit:
    images: Optional[np.ndarray] = None  # [N, H, W, C] in [-1, 1]
    images_highres: Optional[np.ndarray] = None
    tform_cam2world: Optional[np.ndarray] = None  # [N, 4, 4]
    focal_length: Optional[np.ndarray] = None  # [N] (None for ortho)
    bbox: Optional[np.ndarray] = None  # [N, 2, 2] normalized crop
    center: Optional[np.ndarray] = None  # [N, 2]
    classes: Optional[np.ndarray] = None
    num_classes: Optional[int] = None
    depths: Optional[np.ndarray] = None  # [N, H, W] sparse LiDAR (driving)
    masks_occ: Optional[np.ndarray] = None  # occlusion-aware masks (driving)

    fid_stats: Optional[tuple] = None
    eval_indices: Optional[np.ndarray] = None
    eval_indices_perm: Optional[np.ndarray] = None

    def __len__(self):
        return 0 if self.images is None else len(self.images)

    def select(self, indices):
        """Fancy-indexed view over all per-sample arrays."""

        def take(x):
            return None if x is None else x[indices]

        return DatasetSplit(
            images=take(self.images),
            images_highres=take(self.images_highres),
            tform_cam2world=take(self.tform_cam2world),
            focal_length=take(self.focal_length),
            bbox=take(self.bbox),
            center=take(self.center),
            classes=take(self.classes),
            num_classes=self.num_classes,
            depths=take(self.depths),
            masks_occ=take(self.masks_occ),
        )


N_IMAGES_FID_MAX = 8000  # Matches Pix2NeRF evaluation protocol.
EVAL_SEED = 1234


def compute_eval_indices(
    split: DatasetSplit,
    rng: Optional[np.random.RandomState] = None,
    is_imagenet: bool = False,
    n_train_images: Optional[int] = None,
) -> np.ndarray:
    """FID eval subset (reference: run.py:420-439)."""
    rng = rng or np.random.RandomState(EVAL_SEED)
    n = len(split)
    if n > N_IMAGES_FID_MAX:
        return np.sort(rng.permutation(n)[:N_IMAGES_FID_MAX])
    if is_imagenet:
        remaining = n
        out = []
        while remaining > 0:
            out.append(rng.permutation(n)[:remaining])
            remaining -= len(out[-1])
        return np.sort(np.concatenate(out))
    return np.arange(n)


def compute_view_perm(
    target_img_indices: np.ndarray,
    views_per_object: int,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Pairs each eval index with another view of the same object
    (reference: run.py:444-483)."""
    rng = rng or np.random.RandomState(EVAL_SEED)
    if views_per_object == 1:
        # No novel views: random permutation of positions (reference
        # semantics — used only for FID from random views).
        return rng.permutation(len(target_img_indices)).astype(np.int64)

    obj_index = {}
    for idx in target_img_indices:
        obj_index.setdefault(int(idx) // views_per_object, []).append(int(idx))

    perm = []
    for idx in target_img_indices:
        views = obj_index[int(idx) // views_per_object]
        if len(views) == 1:
            perm.append(views[0])
        else:
            while True:
                tentative = int(rng.randint(len(views)))
                # NOTE: the reference compares the *position in views* with
                # the *global image index* (run.py:474-478) — reproduced
                # verbatim for eval comparability.
                if tentative != int(idx):
                    perm.append(views[tentative])
                    break
    return np.asarray(perm, np.int64)


def draw_eval_latents(n: int, latent_dim: int, seed: int = EVAL_SEED):
    """Fixed z draws for FID rendering (reference: run.py:501-516)."""
    rng = np.random.RandomState(seed)
    return rng.standard_normal((n, latent_dim)).astype(np.float32)


class EndlessSampler:
    """Shuffled endless index stream (reference: lib/utils.py EndlessSampler)."""

    def __init__(self, dataset_size: int, rng: np.random.RandomState):
        self.dataset_size = dataset_size
        self.rng = rng
        self._pool = []

    def __call__(self, batch_size: int) -> np.ndarray:
        while len(self._pool) < batch_size:
            self._pool.extend(self.rng.permutation(self.dataset_size).tolist())
        out = self._pool[:batch_size]
        self._pool = self._pool[batch_size:]
        return np.asarray(out, np.int64)


class StepIndexedSampler:
    """Shuffled endless index stream addressed purely by (seed, step).

    Resume-exact without persisted state: the reference checkpoints the
    sampler pointer and numpy RNG (reference: run.py:1475-1516,
    lib/utils.py:87-113 get_state/set_state); here the stream is a pure
    function of the global step, so resuming at iteration i reproduces the
    identical batch sequence with nothing to save.
    """

    def __init__(self, dataset_size: int, seed: int = 1234):
        self.dataset_size = dataset_size
        self.seed = seed
        self._perm_cache = {}

    def _perm(self, epoch: int) -> np.ndarray:
        if epoch not in self._perm_cache:
            if len(self._perm_cache) > 4:
                self._perm_cache.clear()
            self._perm_cache[epoch] = np.random.RandomState(
                self.seed + epoch
            ).permutation(self.dataset_size)
        return self._perm_cache[epoch]

    def __call__(self, step: int, batch_size: int) -> np.ndarray:
        positions = step * batch_size + np.arange(batch_size)
        epochs = positions // self.dataset_size
        offsets = positions % self.dataset_size
        return np.asarray(
            [self._perm(int(e))[int(o)] for e, o in zip(epochs, offsets)],
            np.int64,
        )
