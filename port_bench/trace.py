"""The traced window: torch.profiler (CUPTI) over some units of work, and
its reduction to what the per-layer metrics and the breakdown read.

The arithmetic is the program's own profile_step (device rows only:
kernels, copies and memsets, whose time operator rows repeat) with two
changes: the busy time is the union of the device intervals, so
overlapping streams are not counted twice, and idle time is found as the
gaps between them inside the window, each named by the benchmark's span
(`pb.<name>`, a torch.profiler range around the call into a layer) that
the host was in when the gap began.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class TraceSummary:
    events: List[Tuple[float, float, str]]  # device (start us, end us, name)
    spans: List[Tuple[float, float, str]]  # host pb.* ranges (start us, end us, name)
    window: Tuple[float, float]  # us
    discarded: List[Dict] = dataclasses.field(default_factory=list)
    units: int = 1

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _merged(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        merged: List[List[float]] = []
        for start, end, _ in sorted(self.events):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) * 1e-6

    def time_s(self, keep: Callable[[str], bool]) -> float:
        """Device seconds of the activities whose name `keep` accepts."""
        return sum(end - start for start, end, name in self.events if keep(name)) * 1e-6

    def count(self, part: str) -> int:
        """Device activities with `part` in their name."""
        return sum(1 for _, _, name in self.events if part in name)

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for a, b in self._merged():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def _span_at(self, t: float) -> str:
        """The innermost (shortest) pb.* range holding host time t."""
        inside = [(end - start, name) for start, end, name in self.spans
                  if start <= t < end and name != "window"]
        return min(inside)[1] if inside else "outside_spans"

    def breakdown(self) -> Dict[str, List]:
        by_op: Dict[str, float] = {}
        for start, end, name in self.events:
            by_op[name] = by_op.get(name, 0.0) + (end - start) * 1e-6
        by_span: Dict[str, float] = {}
        for a, b in self.gaps():
            key = self._span_at(a)
            by_span[key] = by_span.get(key, 0.0) + (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


def _is_device(event) -> bool:
    return str(event.device_type).endswith("CUDA")


def profile(fn: Callable[[], None], device: torch.device) -> TraceSummary:
    """Runs fn under torch.profiler inside a `pb.window` range that ends
    after a device synchronize; returns the reduced trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("pb.window"):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events, spans, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("pb.") and _is_device(e):
            continue  # the device's copy of a benchmark range: no work
        if _is_device(e):
            events.append((start, end, e.name))
        elif e.name.startswith("pb."):
            if e.name == "pb.window":
                window = (start, end)
            else:
                spans.append((start, end, e.name[3:]))
    if window is None:
        raise RuntimeError("the profiler's trace lost the window's range")
    return TraceSummary(events, spans, window)
