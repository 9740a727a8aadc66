"""Train checkpoints: one `.pth` per save, written with torch.save.

A checkpoint holds the whole GAN train state (engine/gan.py::GANState
.state_dict: generator, EMA generator, discriminators, optimizer states,
iteration, the path-length average and the augmentation probability).
Its 'model_ema' entry is the EMA generator in the reference's state-dict
names, so `utils/weights.py::load_reference_generator` (the inversion
driver's --resume_from) reads it as it reads a reference checkpoint.

The JAX package's orbax checkpoint directories are not read here.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from nerf_from_image_tpu_torch.utils.weights import _NO_ORBAX

_NUMBERED = re.compile(r"^checkpoint_(\d+)\.pth$")


def save_train_checkpoint(path: str, state: Dict[str, object]) -> None:
    """Writes `state` to `path` (a .pth file), through a temporary file so
    that an interrupted save leaves the previous checkpoint whole."""
    if not path.endswith(".pth"):
        raise ValueError(f"train checkpoints are .pth files, got {path}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_train_checkpoint(path: str) -> Dict[str, object]:
    """Reads a train checkpoint written by save_train_checkpoint (CPU
    tensors). Raises for an orbax checkpoint of the JAX package."""
    if not path.endswith(".pth"):
        raise NotImplementedError(_NO_ORBAX.format(path=path))
    return torch.load(path, map_location="cpu", weights_only=False)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest checkpoint in `directory`: checkpoint_latest.pth if
    there is one, else the highest-numbered checkpoint_N.pth; None if
    there is none."""
    if not os.path.isdir(directory):
        return None
    latest = os.path.join(directory, "checkpoint_latest.pth")
    if os.path.exists(latest):
        return latest
    numbered = [(int(m.group(1)), name) for name in os.listdir(directory)
                if (m := _NUMBERED.match(name))]
    if not numbered:
        return None
    return os.path.join(directory, max(numbered)[1])


def resolve_checkpoint_path(path: str) -> str:
    """A --resume_from value -> a checkpoint file: the file itself, or the
    latest checkpoint of an experiment directory of .pth files. Raises
    for an orbax checkpoint (a directory without .pth checkpoints, or
    another file)."""
    if os.path.isdir(path):
        inner = latest_checkpoint(path)
        if inner is None:
            raise NotImplementedError(_NO_ORBAX.format(path=path))
        return inner
    if not path.endswith(".pth"):
        raise NotImplementedError(_NO_ORBAX.format(path=path))
    return path
