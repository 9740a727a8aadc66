"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries: nothing that is there is edited."""

import json
import os
import shutil
import time

import torch

from port_bench import harness


def test_new_files_are_found_by_name(tiny_root):
    pb = os.path.join(tiny_root, "port_bench")
    shutil.copy(os.path.join(pb, "configs", "shapenet_cars.json"),
                os.path.join(pb, "configs", "added_config.json"))
    with open(os.path.join(pb, "traffic", "gan_b8.json")) as f:
        traffic = json.load(f)
    traffic["pool"] = 3
    with open(os.path.join(pb, "traffic", "added_traffic.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "cells", "shapenet_cars-gan-b8.json")) as f:
        cell = json.load(f)
    cell.update(config="added_config", traffic="added_traffic")
    with open(os.path.join(pb, "cells", "added-cell.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(pb, "metrics", "units_done.py"), "w") as f:
        f.write("def read(run):\n    return float(run.units)\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "added_config", "source": "https://example.org",
                             "file": "port_bench/configs/added_config.json", "reduced": []})
    bench["workloads"].append({"name": "added-cell", "config": "added_config",
                               "traffic": "added_traffic", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("added-cell")
    bench["per_layer"].append({"name": "units_done.train", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "train_images_per_s", "workloads": ["added-cell"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_root, "added-cell", 5, 0.1, True, torch.device("cpu"),
                           time.time())
    metrics = out["result"]["metrics"]
    # The other per-layer metrics list their own cells; the new one lists this.
    assert set(metrics) == {"units_done.train"}
    assert metrics["units_done.train"]["value"] == out["units"]
