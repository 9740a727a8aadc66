"""Re-aggregates a saved inversion report into mean metrics:
`python -m nerf_from_image_tpu_torch.evaluate_saved_result <report.npz>`.

Counterpart of evaluate_saved_result.py, the JAX package's script (the
reference's evaluate_saved_result.py): loads a report written by either
package's InversionReport (reports/<name>/report.npz) and prints each
checkpoint's per-metric means, numpy only.
"""

import sys

import numpy as np


def main(path: str):
    data = np.load(path)
    by_step = {}
    for key in data.files:
        if "/" not in key:  # e.g. the __metric_notes__ sidecar entry
            if key == "__metric_notes__":
                print(f"notes: {data[key]}")
            continue
        step_str, metric = key.split("/", 1)
        by_step.setdefault(step_str, {})[metric] = data[key]
    for step in sorted(by_step, key=lambda s: int(s.replace("step", ""))):
        print(f"[{step}]")
        for metric, values in sorted(by_step[step].items()):
            if metric.startswith("inception_") or metric in ("ws", "z0", "R", "s", "t2"):
                continue
            print(f"  {metric}: {float(np.mean(values)):.5f} (n={np.size(values)})")


if __name__ == "__main__":
    main(sys.argv[1])
