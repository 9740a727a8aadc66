"""One run of one cell: load, warm up, measure, trace, check, report.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in files of its own under `port_bench/`, found by
the names in BENCHMARK.json:

- `cells/<workload>.json`: the cell's configuration and traffic names,
  its counts (model FLOPs and the plane-gradient kernel's bound per unit
  of work), the reference's settings and the limit of each number that
  `correct` compares;
- `configs/<config>.json`: the model configuration as it is run;
- `traffic/<traffic>.json`: the traffic's parameters, and the driver
  (`drivers/<driver>.py`) that runs its units of work;
- `metrics/<name>.py`, or `metrics/<name before the first dot>.py`: the
  reader of a per-layer metric, `read(run) -> float or None`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from port_bench import trace as trace_mod
from port_bench.programs import Side, program, reference

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_from_image_tpu")
# Profiler sessions the traced run takes at most; a session whose trace
# lost device activities (the kernel count disagrees with the program's
# launch counter) is set aside and reported.
TRACE_SESSIONS = 3


@contextlib.contextmanager
def _nothing():
    yield


def no_spans(name: str, count: int = 1):
    return _nothing()


class Spans:
    """Host-clock spans around the calls into each layer, taken only in
    the traced run: each synchronizes the device before and after, and is
    a torch.profiler range named `pb.<name>`. `count` is the number of
    steps a span holds (a refinement call of 30 steps)."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on = device, on
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str, count: int = 1):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"pb.{name}"):
            yield
            self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + count

    def ms(self, name: str) -> Optional[float]:
        """Mean milliseconds per step of the span, or None if none ran."""
        if not self.counts.get(name):
            return None
        return 1e3 * self.seconds[name] / self.counts[name]


@dataclasses.dataclass
class Context:
    """What a driver reads: the device, the seed, the cell's files and the
    side it runs."""

    device: torch.device
    seed: int
    cell: Dict
    config: Dict
    traffic: Dict
    side: Side

    def with_side(self, side: Side) -> "Context":
        return dataclasses.replace(self, side=side)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader reads."""

    workload: str
    cell: Dict
    config: Dict
    peaks: Dict
    units: int
    window_s: float
    steps_per_unit: int
    spans: Spans
    window_peak_bytes: int
    trace: Optional[trace_mod.TraceSummary]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> Dict:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    here = os.path.join(root, "port_bench")
    cell = _json(os.path.join(here, "cells", f"{workload}.json"))
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"cells/{workload}.json names another configuration or traffic "
                         f"than BENCHMARK.json")
    return {
        "bench": bench, "entry": entry, "cell": cell,
        "config": _json(os.path.join(here, "configs", f"{entry['config']}.json")),
        "traffic": _json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
        "peaks": _json(os.path.join(here, "counts", "peaks.json")),
        "root": root,
    }


def driver_module(files: Dict):
    """drivers/<driver>.py of the cell's traffic: its `Driver`, its
    `FAULTS` and `plant`, and its `count_flops`."""
    return importlib.import_module(f"port_bench.drivers.{files['traffic']['driver']}")


def metric_reader(root: str, name: str):
    """The reader module of metric `name`: metrics/<name>.py, else
    metrics/<name before its first dot>.py."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(root, "port_bench", "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"port_bench_metric_{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r} under "
                            f"port_bench/metrics/")


def _applies(metric: Dict, workload: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def cell_metrics(bench: Dict, workload: str, e2e_names: List[str], kind: str) -> List[Dict]:
    """The end-to-end or per-layer metrics BENCHMARK.json gives this cell."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]
    return [m for m in bench["per_layer"] if _applies(m, workload, e2e_names)]


def set_precision(config: Dict) -> None:
    """The configuration's precision: float32 with TF32 off, as the
    program's strict-f32 mode sets it."""
    tf32 = bool(config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(driver, device, seconds: float, spans: Spans) -> Dict:
    """The window: units back to back, the first always, each further one
    while the last unit's time says it ends within `seconds`. Returns the
    units done and the window's seconds (to a device synchronize)."""
    _sync(device)
    t0 = time.perf_counter()
    last = 0.0
    n = 0
    while n == 0 or (time.perf_counter() - t0) + last <= seconds:
        t_unit = time.perf_counter()
        driver.unit(n, spans)
        _sync(device)
        last = time.perf_counter() - t_unit
        n += 1
    return {"units": n, "window_s": time.perf_counter() - t0}


def traced_units(driver, device, side: Side, first_unit: int, n: int) -> Dict:
    """Profiles `n` units after the window (the next `n`, if a session
    lost device activities, up to TRACE_SESSIONS sessions), each layer's
    call in a `pb.<span>` range, and reduces the trace."""
    discarded = []
    for attempt in range(TRACE_SESSIONS):
        spans = Spans(device, True)
        start = first_unit + attempt * n
        launches0 = side.k1_launches()

        def units():
            for i in range(start, start + n):
                driver.unit(i, spans)

        summary = trace_mod.profile(units, device)
        launches = None if launches0 is None else side.k1_launches() - launches0
        if launches is None or summary.count("splat3") == launches:
            summary.discarded = discarded
            summary.units = n
            return summary
        discarded.append({"k1_launches": launches, "k1_in_trace": summary.count("splat3"),
                          "device_ops": len(summary.events)})
    raise RuntimeError(f"every profiler session lost device activities: {discarded}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, process_start: float, side: Optional[Side] = None
             ) -> Dict:
    """Runs the cell once on `side` (the program by default); returns the
    result line's object (its last key 'checks'), every reading and note
    of the check, and the window's units, seconds and K1 launches."""
    files = load_cell(root, workload)
    bench, cell, config = files["bench"], files["cell"], files["config"]
    side = side or program()
    set_precision(config)
    ctx = Context(device, seed, cell, config, files["traffic"], side)
    driver = driver_module(files).Driver(ctx)
    driver.setup()
    _sync(device)
    setup_s = time.time() - process_start
    on_cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    k1_before = side.k1_launches()
    spans = Spans(device, trace)
    window = measure(driver, device, seconds, spans)
    k1_window = None if k1_before is None else side.k1_launches() - k1_before
    window_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    summary = (traced_units(driver, device, side, window["units"], files["traffic"]["traced_units"])
               if trace else None)
    units, window_s = window["units"], window["window_s"]

    e2e_names = [m["name"] for m in cell_metrics(bench, workload, [], "end_to_end")]
    values = dict(driver.end_to_end(units, window_s), setup_s=setup_s)
    if trace:
        view = RunView(workload, cell, config, files["peaks"], units, window_s,
                       driver.steps_per_unit, spans, window_peak, summary)
        chosen = cell_metrics(bench, workload, e2e_names, "per_layer")
        values = {m["name"]: metric_reader(root, m["name"]).read(view) for m in chosen}
        units_of = {m["name"]: m["unit"] for m in chosen}
    else:
        units_of = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        values = {k: v for k, v in values.items() if k in e2e_names}
    metrics = {k: {"value": v, "unit": units_of[k]} for k, v in values.items()
               if v is not None}

    failed = driver.failed(units)
    device_info = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
        "count": 1,
        "memory_peak_bytes": max(setup_peak, window_peak),
    }
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    driver.release()
    if on_cuda:
        torch.cuda.empty_cache()
    readings = driver.check(reference(), units)
    limits = cell["limits"]
    values = {k: float(readings.get(k, math.inf)) for k in limits}
    correct = bool(limits) and all(math.isfinite(values[k]) and values[k] <= limits[k]
                                   for k in limits)
    # JSON has no infinity: a reading that is not a number is written as text.
    checks = {k: {"value": v if math.isfinite(v) else str(v), "limit": limits[k]}
              for k, v in values.items()}
    result = {"correct": correct, "attempted": units * driver.images_per_unit,
              "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return {"result": result, "readings": readings, "notes": driver.notes,
            "k1_window": k1_window,
            "units": units, "window_s": window_s,
            "discarded_sessions": None if summary is None else summary.discarded}
