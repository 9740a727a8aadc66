"""Runs one cell of the benchmark once and prints its result line:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs an NVIDIA card: without one, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
the checks, each number that `correct` compared beside its limit); the
last lines of standard error give the checks again, one a line.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def _fmt(x) -> str:
    return repr(x) if isinstance(x, float) and math.isfinite(x) else str(x)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.seed < 0:
        print("port_bench: --seed must be a whole number of 0 or more", file=sys.stderr)
        return 2
    # Kernel caches at fixed paths inside the checkout: only the first run
    # of a cell there builds (the program builds its kernels into build/).
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    import torch

    from port_bench import harness

    files = harness.load_cell(ROOT, args.workload)
    chips = files["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda"), PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    result = out["result"]
    print(f"port_bench: {args.workload} seed {args.seed}: {out['units']} units in "
          f"{out['window_s']!r} s; plane-gradient kernel launches in the window "
          f"{out['k1_window']} ({None if out['k1_window'] is None else out['k1_window'] / out['units']} "
          f"a unit); discarded profiler sessions {out['discarded_sessions']}", file=sys.stderr)
    print("port_bench: readings " + json.dumps(out["readings"]), file=sys.stderr)
    print("port_bench: notes " + json.dumps(out["notes"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {_fmt(c['value'])} limit {_fmt(c['limit'])}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
