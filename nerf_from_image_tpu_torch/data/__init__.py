"""The data layer: dataset configs, in-memory splits and the loaders.

This package's copy of the JAX package's data/ (configs, splits,
image_ops, synthetic, coco_mask, custom, srn, carla, loaders), numpy only.
"""

from nerf_from_image_tpu_torch.data.configs import (  # noqa: F401
    DatasetConfig,
    get_dataset_config,
    DATASET_CONFIGS,
)
