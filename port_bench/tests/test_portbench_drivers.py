"""Each driver's set-up, window loop, traced units and check against the
frozen reference, at a tiny size on the CPU, through the harness's own
run (only its look for a card is skipped): the result has the contract's
shape, a sound run reads nought or rounding, and each fault a cell can
have makes `correct` false under the cell's own limits."""

import json
import math
import os
import time

import pytest
import torch

from conftest import ROOT
from port_bench import faults, harness
from port_bench.programs import program

SEED = 2**31 + 77
CELLS = ("p3d_car-invert-hybrid-b8", "shapenet_cars-gan-b8")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", CELLS)
def test_run_has_the_contracts_shape(tiny_root, workload, trace):
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_root, workload, SEED, 0.5, bool(trace), torch.device("cpu"),
                           time.time())
    result = out["result"]
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = _bench()
    e2e = [m["name"] for m in harness.cell_metrics(bench, workload, [], "end_to_end")]
    if trace:
        want = {m["name"] for m in harness.cell_metrics(bench, workload, e2e, "per_layer")}
        # On the CPU no kernel of the plane gradient runs: its reader is silent.
        assert set(result["metrics"]) == want - {n for n in want if n.startswith("k1_")}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == set(e2e)
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    limits = set(harness.load_cell(tiny_root, workload)["cell"]["limits"])
    assert set(result["checks"]) == limits and limits <= set(out["readings"])
    # A sound run on the CPU: the program and the reference agree to rounding.
    assert all(v < 1e-4 for v in out["readings"].values()), out["readings"]
    assert json.loads(json.dumps(result)) == result


def _faults():
    return [(w, f) for w in CELLS for f in faults.of(harness.load_cell(ROOT, w))]


@pytest.mark.parametrize("workload,fault", _faults())
def test_each_fault_fails_correct(tiny_root, workload, fault):
    torch.set_num_threads(2)
    files = harness.load_cell(tiny_root, workload)
    side = faults.broken(program(), files, fault)
    out = harness.run_cell(tiny_root, workload, SEED, 0.1, False, torch.device("cpu"),
                           time.time(), side=side)
    assert out["result"]["correct"] is False, out["readings"]
