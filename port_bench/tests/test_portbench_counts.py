"""The counts the per-layer metrics divide by: the plane-gradient
kernel's bound, and the model FLOPs each cell's file keeps, counted again
on the meta device."""

import json
import os

import pytest

from conftest import ROOT
from port_bench.counts import flops, k1


def test_k1_bound_reproduces_the_programs_figure():
    # B=4, the coarse points of a 128^2 x 64 render, 3 planes 256^2 x 32:
    # 0.205 ms, bound by bytes (chip_smoke.py's K1 line).
    assert k1.bound_ms(4, 128 * 128 * 64, 256, 256, 32) == pytest.approx(0.2053, abs=5e-5)


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_stored_counts_match_a_recount(workload):
    with open(os.path.join(ROOT, "port_bench", "cells", f"{workload}.json")) as f:
        stored = json.load(f)["counts"]
    assert flops.counts(ROOT, workload) == stored
