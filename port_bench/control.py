"""The two readings each limit of `correct` is set from, at the cell's own
size, many seeds in one process:

    python3 -m port_bench.control --workload <name> --seeds 11,12,13 \\
        --side program|control [--fault <one of the driver's FAULTS>]

`program` runs the cell's set-up and one unit of work as the benchmark
does (the lower readings: sound runs); `control` runs the reference in
the program's place in the nearest precision below the configuration's
(TF32 for float32 with TF32 off); `--fault` runs the program with a
fault planted (`plant` in the cell's drivers/<name>.py). Each seed's readings are then taken
by the cell's own check against the reference in the configuration's
precision, and printed as one JSON line. It needs a card, as the
benchmark does; it is not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from port_bench import faults, harness
from port_bench.programs import program, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, workload: str, seed: int, side_name: str, fault, device) -> dict:
    files = harness.load_cell(root, workload)
    config = files["config"]
    side = reference() if side_name == "control" else program()
    if fault:
        side = faults.broken(side, files, fault)
    harness.set_precision(config)
    if side_name == "control":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    ctx = harness.Context(device, seed, files["cell"], config, files["traffic"], side)
    driver = harness.driver_module(files).Driver(ctx)
    t0 = time.perf_counter()
    driver.setup()
    driver.unit(0, harness.no_spans)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    driver.release()
    harness.set_precision(config)
    t0 = time.perf_counter()
    got = driver.check(reference(), 1)
    return {"seed": seed, "side": side_name, "fault": fault, "readings": got,
            "notes": driver.notes,
            "run_s": run_s, "check_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--side", choices=("program", "control"), default="program")
    parser.add_argument("--fault", default=None,
                        help="one of the cell's driver's FAULTS")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device is available", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(ROOT, args.workload, seed, args.side, args.fault, torch.device("cuda"))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
