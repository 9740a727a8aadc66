"""The distillation cell's driver (drivers/encoder_distill.py) at a tiny
size on the CPU, through the harness's own run: the result has the
contract's shape, a sound run reads nought or rounding, the window runs
no plane-gradient kernel, and each planted fault makes `correct` false.
On a card, the cell's limits part a sound run from the control. (Its
FLOP count and its imports are held with every cell's, in
test_portbench_counts.py and test_portbench_imports.py.)"""

import json
import math
import os
import time

import pytest
import torch

from conftest import ROOT
from port_bench import control, faults, harness
from port_bench.programs import program

WORKLOAD = "p3d_car-distill-b32"
SEED = 2**33 + 5


@pytest.mark.parametrize("trace", (0, 1))
def test_run_has_the_contracts_shape(tiny_root, trace):
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_root, WORKLOAD, SEED, 0.5, bool(trace), torch.device("cpu"),
                           time.time())
    result = out["result"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = [m["name"] for m in harness.cell_metrics(bench, WORKLOAD, [], "end_to_end")]
    assert set(e2e) == {"train_images_per_s", "setup_s"}
    if trace:
        want = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, e2e, "per_layer")}
        assert set(result["metrics"]) == want
        assert {"encoder_ms.distill", "encoder_update_ms.distill", "render_ms.distill",
                "backward_ms.distill"} <= want
    else:
        assert set(result["metrics"]) == set(e2e)
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    limits = set(harness.load_cell(tiny_root, WORKLOAD)["cell"]["limits"])
    assert set(result["checks"]) == limits and limits <= set(out["readings"])
    assert result["correct"] is True, out["readings"]
    # A sound run on the CPU: the program and the reference agree to rounding.
    assert all(v < 1e-5 for v in out["readings"].values()), out["readings"]
    assert out["notes"]["program_target_image_rendered_again"] == 0.0
    assert out["notes"]["reference_target_image_rendered_again"] == 0.0
    assert out["notes"]["k1_launches_after_setup"] == 0 and out["k1_window"] == 0


@pytest.mark.parametrize("fault", faults.of(harness.load_cell(ROOT, WORKLOAD)))
def test_each_fault_fails_correct(tiny_root, fault):
    torch.set_num_threads(2)
    files = harness.load_cell(tiny_root, WORKLOAD)
    side = faults.broken(program(), files, fault)
    out = harness.run_cell(tiny_root, WORKLOAD, SEED, 0.1, False, torch.device("cpu"),
                           time.time(), side=side)
    assert out["result"]["correct"] is False, out["readings"]


@pytest.mark.card
@pytest.mark.parametrize("side", ("program", "control"))
def test_limits_part_program_and_control(card, side):
    got = control.readings(ROOT, WORKLOAD, 2**31 + 101, side, None, card)["readings"]
    limits = harness.load_cell(ROOT, WORKLOAD)["cell"]["limits"]
    over = {k: got[k] for k, limit in limits.items() if not got[k] <= limit}
    assert bool(over) == (side == "control"), (got, over)
