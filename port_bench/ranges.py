"""The host time of the program's own profiler ranges in the traced
units: what the per-layer metrics of a layer inside the program read.

The program names its layer boundaries with ranges of the benchmark's
prefix (`pb.`, nerf_from_image_tpu_torch/utils/trace.py), so the trace
reduction keeps them among `TraceSummary.spans`, prefix stripped, on the
profiler's clock. A program without such a range (an older commit) gives
None, and its metric is left out of the result line.
"""

from __future__ import annotations

from typing import Optional


def host_ms(run, name: str) -> Optional[float]:
    """Milliseconds of host time inside the range `name` and the ranges
    under it (`render` holds `render.coarse`), as the union of their
    intervals, per traced unit; None when the trace holds no such range."""
    t = run.trace
    if t is None:
        return None
    intervals = sorted((a, b) for a, b, n in t.spans if n == name or n.startswith(name + "."))
    if not intervals:
        return None
    total, end = 0.0, -float("inf")
    for a, b in intervals:
        if b > end:
            total += b - max(a, end)
            end = b
    return 1e-3 * total / t.units
