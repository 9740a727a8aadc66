"""The numbers `correct` compares: gaps between what the program produced
and what the reference works out again from the same inputs.

Every gap is a share: 0 is agreement, 1 is a value that is all wrong.
A non-finite reading stays non-finite, and fails any limit.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import torch


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want| (the tensors' elementwise
    gap, against their scale)."""
    got, want = got.detach().double(), want.detach().double().to(got.device)
    if got.shape != want.shape:
        return math.inf
    if not bool(torch.isfinite(got).all()):
        return math.inf
    scale = float(want.abs().max()) if want.numel() else 0.0
    gap = float((got - want).abs().max()) if want.numel() else 0.0
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def rel_each(got: Sequence[float], want: Sequence[float]) -> float:
    """The largest |got - want| / |want| over paired scalars (a loss per
    step)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = float(g), float(w)
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - w) / abs(w) if w != 0 else (0.0 if g == 0 else math.inf))
    return worst


def leaf_norms(tensors: Iterable[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.detach().double())) for t in tensors]


def leaf_gaps(got: Sequence[float], want: Sequence[float],
              keep: Sequence[bool] = ()) -> List[float]:
    """Each kept leaf's gap of norms: |‖got‖ - ‖want‖| over the larger of
    the reference's norm of that leaf and of the median kept leaf's (a
    non-finite norm is all wrong); `keep` marks the leaves (all when
    empty)."""
    if len(got) != len(want):
        return [math.inf]
    keep = list(keep) or [True] * len(want)
    kept = sorted(w for w, k in zip(want, keep) if k)
    if not kept:
        return [math.inf]
    median = kept[len(kept) // 2]
    out = []
    for g, w, k in zip(got, want, keep):
        if k:
            scale = max(w, median)
            out.append(math.inf if not math.isfinite(g)
                       else (abs(g - w) / scale if scale > 0 else 0.0))
    return out


def worst_leaf(got: Sequence[float], want: Sequence[float],
               keep: Sequence[bool] = ()) -> float:
    """The worst leaf's gap of norms (leaf_gaps)."""
    return max(leaf_gaps(got, want, keep))


def moved(first_grads: Sequence[float], share: float = 1e-3) -> List[bool]:
    """The leaves whose reference gradient is not nought to rounding: at
    least `share` of the median leaf's norm. The others (a bias under a
    softmax) move under Adam by round-off alone."""
    ordered = sorted(first_grads)
    median = ordered[len(ordered) // 2] if ordered else 0.0
    return [g >= share * median for g in first_grads]


def metrics_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The worst rel_max over the metrics both dicts hold; a metric
    missing on one side is all wrong."""
    if set(got) != set(want):
        return math.inf
    return max((rel_max(got[k], want[k]) for k in want), default=0.0)
