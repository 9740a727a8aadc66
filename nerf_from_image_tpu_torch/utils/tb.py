"""TensorBoard logging sink (scalars + image grids).

Mirrors the reference's TensorBoard usage (reference: run.py:1407-1472
image grids, scalar curves) through tensorboardX; degrades to a no-op when
the package is unavailable. This package's copy of the JAX package's
utils/tb.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Logger:
    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir is not None:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(log_dir)
            except ImportError:
                pass

    def scalar(self, tag: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def scalars(self, metrics: dict, step: int, prefix: str = ""):
        for k, v in metrics.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def images(self, tag: str, images, step: int):
        """images: [N, H, W, C] in [-1, 1] or [0, 1]."""
        if self._writer is None:
            return
        arr = np.asarray(images)
        if arr.min() < -0.01:
            arr = arr / 2.0 + 0.5
        arr = np.clip(arr, 0.0, 1.0)
        self._writer.add_images(tag, arr, step, dataformats="NHWC")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
