"""Top-level dataset loading: dispatch + per-dataset training overrides.

Re-design of the reference loader layer (reference: data/loaders.py:90-501):
`load_dataset(name, ...)` returns (DatasetConfig, train, train_eval, test)
DatasetSplits with the reference's exact materialization semantics (highres
2x + avg-pool pair when ADA is on, crop=True for the eval split, CUB ortho
focal/bbox clearing, train bbox=None). This package's copy of the JAX
package's data/loaders.py; images are read by utils/images.py (PNG in
numpy, other formats through imageio) and resized by data/image_ops.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from nerf_from_image_tpu_torch.data import image_ops
from nerf_from_image_tpu_torch.data.configs import DatasetConfig, get_dataset_config
from nerf_from_image_tpu_torch.data.splits import DatasetSplit


@dataclasses.dataclass
class TrainOverrides:
    """Per-dataset hyperparameter presets (reference: data/loaders.py:90-123)."""

    iterations: int = 300000
    disable_stylegan_noise: bool = True
    supervise_alpha: bool = False
    augment_p: float = 0.0
    augment_ada: bool = False
    inv_use_testset: bool = False
    inv_no_optimize_pose: bool = False
    use_viewdir: bool = False
    r1: float = 5.0


def get_train_overrides(dataset: str) -> TrainOverrides:
    o = TrainOverrides()
    if dataset == "cub":
        o.iterations = 200000
        o.disable_stylegan_noise = False
        o.supervise_alpha = True
        o.augment_p = 0.8
        o.augment_ada = True
        o.inv_use_testset = True
    if dataset.startswith("imagenet"):
        o.supervise_alpha = True
        o.augment_p = 0.8
        o.augment_ada = True
    if dataset == "imagenet_elephant":
        o.iterations = 200000
        o.disable_stylegan_noise = False
        o.r1 = 10.0
    if dataset.startswith("p3d"):
        o.supervise_alpha = True
        o.augment_p = 0.8
        o.augment_ada = True
        o.inv_use_testset = True
    if dataset == "carla":
        o.use_viewdir = True
        o.augment_p = 0.8
        o.augment_ada = True
    if dataset.startswith("shapenet"):
        o.inv_use_testset = True
        o.inv_no_optimize_pose = True
    return o


def _materialize_collection(collection, highres: bool) -> DatasetSplit:
    images, images_hr, poses, focals, bboxes, classes = [], [], [], [], [], []
    for sample in collection:
        img = sample["img"]
        if highres:
            images_hr.append(np.clip(img, -1, 1))
            images.append(np.clip(image_ops.avg_pool2(img), -1, 1))
        else:
            images.append(np.clip(img, -1, 1))
        poses.append(sample["pose"])
        focals.append(sample["focal"])
        bboxes.append(sample["normalized_bbox"])
        classes.append(sample["class"])
    classes = np.asarray(classes)
    return DatasetSplit(
        images=np.stack(images),
        images_highres=np.stack(images_hr) if highres else None,
        tform_cam2world=np.stack(poses),
        focal_length=np.concatenate(focals).reshape(-1),
        bbox=np.stack(bboxes),
        classes=classes,
        num_classes=int(classes.max()) + 1 if len(classes) else None,
    )


def load_dataset(
    dataset: str,
    data_path: str,
    resolution: int = 128,
    augment_p: Optional[float] = None,
    need_test: bool = False,
    use_class: bool = False,
    max_images: Optional[int] = None,
    imagenet_testset: bool = False,
) -> Tuple[DatasetConfig, DatasetSplit, DatasetSplit, Optional[DatasetSplit]]:
    config = get_dataset_config(dataset)
    overrides = get_train_overrides(dataset)
    if augment_p is None:
        augment_p = overrides.augment_p
    highres = augment_p > 0 and config.is_highres

    if dataset.startswith("shapenet"):
        from nerf_from_image_tpu_torch.data.srn import load_srn_split

        category = dataset.split("_")[1]
        path = os.path.join(data_path, "shapenet", category)
        train = load_srn_split(path, "train", resolution,
                               max_objects=max_images)
        train_eval = train
        test = (
            load_srn_split(path, "test", resolution, max_objects=max_images)
            if need_test
            else None
        )
        return config, train, train_eval, test

    if dataset == "carla":
        from nerf_from_image_tpu_torch.data.carla import load_carla_split

        train = load_carla_split(
            os.path.join(data_path, "carla"), resolution, highres,
            max_images=max_images,
        )
        return config, train, train, None

    if dataset == "synthetic":
        from nerf_from_image_tpu_torch.data.synthetic import make_synthetic_split

        train = make_synthetic_split(max_images or 64, resolution)
        test = (
            make_synthetic_split(max_images or 64, resolution, seed=1)
            if need_test
            else None
        )
        return config, train, train, test

    # p3d / imagenet / cub collections.
    from nerf_from_image_tpu_torch.data.custom import CUBCollection, CustomCollection

    if dataset == "cub":
        inst = lambda split, size, crop, mirrored: CUBCollection(
            split, size, data_path, crop=crop, add_mirrored=mirrored
        )
    else:
        inst = lambda split, size, crop, mirrored: CustomCollection(
            dataset, split, size, data_path, crop=crop, add_mirrored=mirrored
        )

    size_train = resolution * 2 if augment_p > 0 else resolution
    train = _materialize_collection(
        inst("train", size_train, False, True), highres=augment_p > 0
    )
    train_eval = _materialize_collection(
        inst("train", resolution, True, False), highres=False
    )
    test = None
    if need_test and config.views_per_object_test:
        # p3d_car optionally evaluates on held-out ImageNet-car images
        # (reference: data/loaders.py:271-276, --inv_use_imagenet_testset).
        test_name = (
            "imagenet_test"
            if (dataset == "p3d_car" and imagenet_testset)
            else "test"
        )
        test = _materialize_collection(
            inst(test_name, resolution, True, False), highres=False
        )
        # (test keeps its crop bbox — only train/cub bboxes are cleared
        # below, matching the reference.)

    # Reference post-processing (data/loaders.py:377-399).
    if dataset == "cub":
        train.focal_length = None
        train.bbox = None
        train_eval.focal_length = None
        train_eval.bbox = None
        if test is not None:
            test.focal_length = None
            test.bbox = None
    else:
        train.bbox = None  # training images are always uncropped

    if not use_class or dataset != "cub":
        train.classes = None
        train.num_classes = None
        train_eval.classes = None
        train_eval.num_classes = None

    return config, train, train_eval, test


def autodetect_dataset(experiment_name: str) -> str:
    """Dataset from a checkpoint/experiment name (reference:
    data/loaders.py:197-210)."""
    choices = [
        "shapenet_cars", "shapenet_chairs", "p3d_car", "cub", "carla",
        "imagenet_car", "imagenet_airplane", "imagenet_motorcycle",
        "imagenet_zebra", "imagenet_elephant",
    ]
    found = None
    for choice in choices:
        if f"_{choice}_" in experiment_name:
            assert found is None
            found = choice
    if not found:
        raise RuntimeError("Unable to autodetect dataset")
    return found


def get_coco_mapping() -> dict:
    """Dataset -> COCO class id for demo-image detection (reference:
    data/loaders.py:140-149)."""
    return {
        "p3d_car": 2,
        "cub": 14,
        "imagenet_car": 2,
        "imagenet_airplane": 4,
        "imagenet_motorcycle": 3,
        "imagenet_zebra": 22,
        "imagenet_elephant": 20,
    }


def load_manual_image(path_or_url: str, img_size: int,
                      coco_class_id: Optional[int] = None) -> dict:
    """Loads an externally supplied demo image and prepares it for
    inversion: mask extraction, padded square-bbox crop, resize,
    background removal (reference: lib/utils.py:116-161 +
    data/loaders.py:228-237 insert_manual_image).

    Mask sources, in priority order:
      1. the image's alpha channel (RGBA input);
      2. a sibling `<stem>_mask.png` (white = foreground);
      3. detectron2 Mask-RCNN on `coco_class_id` (only if detectron2 is
         importable — it is an optional dependency; the reference requires
         it unconditionally).

    Returns {'img': [S, S, 4] float32 in [-1, 1] (RGB * mask, mask),
             'normalized_bbox': [2, 2] crop rectangle in [-1, 1] coords}.
    """
    from nerf_from_image_tpu_torch.utils.images import read_image

    if path_or_url.startswith("http"):
        raise ValueError(
            "URL inputs need network access; download the image first"
        )
    img = read_image(path_or_url).astype(np.float64)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img / 255.0

    mask = None
    if img.shape[-1] == 4:
        mask = (img[..., 3:] > 0.5).astype(np.float64)
        img = img[..., :3]
    else:
        img = img[..., :3]
        stem, _ = os.path.splitext(path_or_url)
        mask_path = stem + "_mask.png"
        if os.path.exists(mask_path):
            m = read_image(mask_path).astype(np.float64)
            if m.ndim == 3:
                m = m[..., 0]
            mask = (m > 127)[..., None].astype(np.float64)
    if mask is None:
        try:
            import detectron2.config
            import detectron2.engine
            import detectron2.model_zoo
        except ImportError as e:
            raise RuntimeError(
                "No mask found: supply an RGBA image or a <stem>_mask.png "
                "(detectron2 auto-masking is unavailable here)"
            ) from e
        cfg_file = (
            "COCO-InstanceSegmentation/mask_rcnn_X_101_32x8d_FPN_3x.yaml"
        )
        cfg = detectron2.config.get_cfg()
        cfg.merge_from_file(detectron2.model_zoo.get_config_file(cfg_file))
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
        cfg.MODEL.WEIGHTS = detectron2.model_zoo.get_checkpoint_url(cfg_file)
        predictor = detectron2.engine.DefaultPredictor(cfg)
        outputs = predictor(
            (img[:, :, ::-1] * 255).astype(np.uint8)
        )["instances"]
        outputs = outputs[outputs.pred_classes == coco_class_id]
        if len(outputs) == 0:
            raise RuntimeError(
                "Could not detect any object in the provided image"
            )
        areas = outputs.pred_masks.sum(dim=[1, 2])
        best = int(areas.argmax())
        mask = np.asarray(
            outputs.pred_masks[best].cpu().float()
        )[..., None].astype(np.float64)

    ys, xs = np.nonzero(mask[..., 0] > 0.5)
    if len(ys) == 0:
        raise RuntimeError("Empty mask in the provided image")
    bbox = [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]
    bbox = image_ops.perturb_bbox(bbox, pf=0.05)
    bbox = image_ops.square_bbox(bbox)
    nbbox = image_ops.normalized_bbox(bbox, img.shape[0], img.shape[1])

    img_c = image_ops.crop_padded(img, bbox, bgval=1)
    mask_c = image_ops.crop_padded(mask, bbox, bgval=0)
    scale = img_size / float(max(img_c.shape[0], img_c.shape[1]))
    img_r, _ = image_ops.resize_area(img_c, scale)
    mask_r, _ = image_ops.resize_area(mask_c, scale)
    mask_out = mask_r[..., 0] if mask_r.ndim == 3 else mask_r
    img_out = (img_r * 2 - 1) * mask_out[..., None]
    img_out = np.concatenate((img_out, mask_out[..., None]), axis=-1)
    return {
        "img": img_out.astype(np.float32),
        "normalized_bbox": nbbox.astype(np.float32),
    }
