"""Per-dataset configuration registry.

Mirrors the reference's dataset config dictionaries (reference:
data/loaders.py:23-123) as a frozen dataclass. This package's copy of the
JAX package's data/configs.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str
    scene_range: float
    white_background: bool
    has_mask: bool
    has_bbox: bool
    is_highres: bool
    views_per_object: int
    views_per_object_test: Optional[int]
    camera_projection_model: str  # 'perspective' | 'ortho'
    camera_flipped: bool

    @property
    def is_ortho(self) -> bool:
        return self.camera_projection_model == "ortho"


def _cfg(name, **kw):
    return DatasetConfig(name=name, **kw)


_SHAPENET = dict(
    scene_range=1.1 / 2,
    white_background=True,
    has_mask=False,
    has_bbox=False,
    is_highres=False,
    views_per_object=50,
    views_per_object_test=251,
    camera_projection_model="perspective",
    camera_flipped=False,
)
_P3D = dict(
    scene_range=1.4,
    white_background=False,
    has_mask=True,
    has_bbox=True,
    is_highres=True,
    views_per_object=1,
    views_per_object_test=1,
    camera_projection_model="perspective",
    camera_flipped=True,
)
_IMAGENET = dict(_P3D, views_per_object_test=None)
_CUB = dict(
    scene_range=2.0,
    white_background=False,
    has_mask=True,
    has_bbox=True,
    is_highres=True,
    views_per_object=1,
    views_per_object_test=1,
    camera_projection_model="ortho",
    camera_flipped=True,
)
_CARLA = dict(
    scene_range=3.0,
    white_background=True,
    has_mask=False,
    has_bbox=False,
    is_highres=True,
    views_per_object=1,
    views_per_object_test=None,
    camera_projection_model="perspective",
    camera_flipped=False,
)
# Driving evals (nuScenes/KITTI/Waymo) override to a wider scene range and
# white background (reference: eval_nusc_persp.py:830).
_DRIVING = dict(
    scene_range=3.0,
    white_background=True,
    has_mask=True,
    has_bbox=True,
    is_highres=False,
    views_per_object=1,
    views_per_object_test=1,
    camera_projection_model="perspective",
    camera_flipped=True,
)

_SYNTHETIC = dict(
    scene_range=0.55,
    white_background=True,
    has_mask=False,
    has_bbox=False,
    is_highres=False,
    views_per_object=1,
    # A held-out synthetic test split exists (fresh procedural draw), so
    # the train-time test-split evaluation path (reference:
    # run.py:1391-1398) is exercisable without external data.
    views_per_object_test=1,
    camera_projection_model="perspective",
    camera_flipped=False,
)

DATASET_CONFIGS = {
    "synthetic": _cfg("synthetic", **_SYNTHETIC),
    "shapenet_cars": _cfg("shapenet_cars", **_SHAPENET),
    "shapenet_chairs": _cfg("shapenet_chairs", **_SHAPENET),
    "p3d_car": _cfg("p3d_car", **_P3D),
    "imagenet_car": _cfg("imagenet_car", **_IMAGENET),
    "imagenet_airplane": _cfg("imagenet_airplane", **_IMAGENET),
    "imagenet_motorcycle": _cfg("imagenet_motorcycle", **_IMAGENET),
    "imagenet_zebra": _cfg("imagenet_zebra", **_IMAGENET),
    "imagenet_elephant": _cfg("imagenet_elephant", **_IMAGENET),
    "cub": _cfg("cub", **_CUB),
    "carla": _cfg("carla", **_CARLA),
    "nusc": _cfg("nusc", **_DRIVING),
    "kitti": _cfg("kitti", **_DRIVING),
    "waymo": _cfg("waymo", **_DRIVING),
}


def get_dataset_config(name: str) -> DatasetConfig:
    if name.startswith("shapenet"):
        return dataclasses.replace(DATASET_CONFIGS["shapenet_cars"], name=name)
    if name.startswith("p3d_"):
        return dataclasses.replace(DATASET_CONFIGS["p3d_car"], name=name)
    if name.startswith("imagenet_"):
        return dataclasses.replace(DATASET_CONFIGS["imagenet_car"], name=name)
    if name in DATASET_CONFIGS:
        return DATASET_CONFIGS[name]
    raise ValueError(f"Unknown dataset: {name}")
