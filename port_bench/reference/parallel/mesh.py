"""One process, one device: the world-size-1 behaviour of the program's
data-parallel helpers, which the copied modules call. Draws are taken at
the shape asked for, and every collective returns its input."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch


def world_size() -> int:
    return 1


def rank() -> int:
    return 0


def local_batch(global_batch: int) -> int:
    return global_batch


def row_block(n: int) -> slice:
    return slice(0, n)


@contextlib.contextmanager
def sharded_draws(axis: int = 0):
    yield


def sharded_step(fn):
    return fn


def batch_sharded() -> bool:
    return False


def draw(fn: Callable[..., torch.Tensor], shape, **kwargs) -> torch.Tensor:
    return fn(tuple(shape), **kwargs)


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return tensors


def mean(t: torch.Tensor) -> torch.Tensor:
    return t


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return metrics


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return x
