"""On the card, at each cell's own size: a sound run of the program is
within every limit of `correct`, and the control (the reference in the
program's place with TF32 on, the precision below the configuration's
f32) is outside at least one. `python -m pytest port_bench/tests -m card`
on a machine with an NVIDIA card; they skip without one."""

import json
import os

import pytest

from conftest import ROOT
from port_bench import control

CELLS = ("p3d_car-invert-hybrid-b8", "shapenet_cars-gan-b8")


def _limits(workload):
    with open(os.path.join(ROOT, "port_bench", "cells", f"{workload}.json")) as f:
        return json.load(f)["limits"]


@pytest.mark.card
@pytest.mark.parametrize("side", ("program", "control"))
@pytest.mark.parametrize("workload", CELLS)
def test_limits_part_program_and_control(card, workload, side):
    got = control.readings(ROOT, workload, 2**31 + 101, side, None, card)["readings"]
    over = {k: got[k] for k, limit in _limits(workload).items() if not got[k] <= limit}
    assert bool(over) == (side == "control"), (got, over)
