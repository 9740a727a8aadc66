"""Device selection and the strict-f32 numeric mode."""

from __future__ import annotations

from typing import Callable, Hashable, Optional

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    'cuda' (the default everywhere in this package) requires a card; only
    an explicit 'cpu' runs on the CPU. There is no silent fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def check_on_device(dev: torch.device, **tensors) -> None:
    """Raises if any given (non-None) tensor lies on another device type."""
    for name, t in tensors.items():
        if t is not None and t.device.type != dev.type:
            raise ValueError(
                f"{name} is on {t.device}, expected the entry point's "
                f"device {dev}"
            )


def to_device(x, device, dtype=torch.float32) -> Optional[torch.Tensor]:
    """A host array (or None, which stays None) as a tensor of `dtype` on
    `device`."""
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


# Constants of the hot path, by key (see `constant`).
_CONSTANTS: dict = {}


def constant(key: Hashable, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The tensor `make()` returns, made on the first call with `key` and
    shared by every later one: callers must not modify it in place.

    A tensor made from a Python number or a numpy array on each call is a
    copy from pageable host memory, which waits until the device's queue
    has drained. The key names everything the tensor depends on (device,
    dtype, values). It is made outside inference mode, so that autograd
    may save it for a backward.
    """
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS.setdefault(key, make())
    return t


def set_strict_f32() -> None:
    """Full-f32 matmuls and convolutions on the card (TF32 off).

    The reference pins f32; cuDNN convolutions default to TF32 in PyTorch,
    which keeps only ~3 decimal digits in the synthesis network.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
