"""Model FLOPs per unit of a cell's work, counted once by
torch.utils.flop_counter.FlopCounterMode over the frozen reference at the
cell's shapes on the meta device (shapes only, no data): the matrix
products and convolutions, forward and backward, that the unit's
networks run. Elementwise passes, the optimizers' updates and PnP's
small solves are not model FLOPs and are not counted.

    python3 -m port_bench.counts.flops --workload <name>

prints the counts that the cell's file keeps under "counts". Each
driver counts its own unit of work (`count_flops` in drivers/<name>.py)
with the helpers here.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import harness
from port_bench.programs import reference

META = torch.device("meta")


class _NoModules:
    """Stands in for the counter's module tracker, whose hooks break
    autograd.grad over a leaf (R1) and no_grad renders of trained
    parameters: every count goes to the global total."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def flops_of(fn) -> int:
    """Model FLOPs of `fn()`, by the counter."""
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _NoModules()
    with counter:
        fn()
    return int(counter.get_total_flops())


def meta_driver(files: Dict, driver_cls):
    """The driver `driver_cls` built over the reference on the meta device,
    its queries unchunked: model FLOPs leave out the chunks' recomputation
    in the backward (the meta device holds any size)."""
    config = dict(files["config"], render=dict(files["config"]["render"], query_chunk=0))
    ctx = harness.Context(META, 0, files["cell"], config, files["traffic"], reference())
    driver = driver_cls(ctx)
    driver.build()
    return driver


def counts(root: str, workload: str) -> Dict[str, object]:
    """The counts of the cell's driver (`count_flops` of
    drivers/<driver>.py)."""
    files = harness.load_cell(root, workload)
    return harness.driver_module(files).count_flops(files)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(json.dumps(counts(root, args.workload)))


if __name__ == "__main__":
    main()
