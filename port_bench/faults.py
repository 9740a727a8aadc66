"""The program with one part broken underneath the driver, for checking
that `correct` fails on the faults a cell can have. Each driver names
its faults (`FAULTS`, each caught; `UNCAUGHT`, planted only for their
readings) and plants them (`plant(side, fault)`) in drivers/<name>.py;
this module finds them by the cell and holds what they share. The
exchange between chips has no fault here: every cell runs on one.
"""

from __future__ import annotations

import types
from typing import Dict

from port_bench import harness
from port_bench.programs import Side


def replaced(side: Side, **modules) -> Side:
    """A copy of `side` with the named modules replaced."""
    out = Side.__new__(Side)
    out.__dict__.update(side.__dict__, **modules)
    return out


def module(original, **replace):
    """`original`'s names, with some replaced."""
    return types.SimpleNamespace(**{**vars(original), **replace})


def half(batch: Dict) -> Dict:
    """The first half of every row of a batch."""
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def of(files: Dict):
    """The faults the cell's driver can have, each of which `correct`
    catches."""
    return harness.driver_module(files).FAULTS


def broken(side: Side, files: Dict, fault: str) -> Side:
    """`side` with `fault` planted under the cell's driver."""
    driver = harness.driver_module(files)
    known = driver.FAULTS + getattr(driver, "UNCAUGHT", ())
    if fault not in known:
        raise ValueError(f"unknown fault {fault!r}; one of {known}")
    return driver.plant(side, fault)
