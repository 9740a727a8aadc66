"""The benchmark's own tests: `python -m pytest port_bench/tests` from the
repository's root. Tests marked `card` need an NVIDIA card and skip
without one; the decision is taken in the `card` fixture, never while a
module is imported. Nothing here imports JAX or the JAX package."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _edit(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like root holding BENCHMARK.json and the benchmark's data
    files, with every configuration cut to a size the CPU runs in seconds
    (the code stays the repository's)."""
    root = tmp_path / "root"
    pb = root / "port_bench"
    for d in ("cells", "configs", "traffic", "metrics", "counts"):
        shutil.copytree(os.path.join(ROOT, "port_bench", d), pb / d)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)

    def config(c):
        c["batch_size"] = 2
        c["render"].update(resolution=32, depth_samples_per_ray=8,
                           query_chunk=c["render"]["query_chunk"] and 2048)
        c["generator"]["synthesis_resolution"] = 32
        if "encoder" in c:
            c["encoder"]["depths"] = [1, 1, 1, 1]
        if "inversion" in c:
            c["inversion"].update(steps=3, num_augmentations=2)

    for name in os.listdir(pb / "configs"):
        _edit(pb / "configs" / name, config)

    def traffic(t):
        for key in ("target_sets", "pool"):
            if key in t:
                t[key] = 4

    for name in os.listdir(pb / "traffic"):
        _edit(pb / "traffic" / name, traffic)

    def cell(c):
        if "check_steps" in c:
            c["check_steps"] = 2
        if "check_units" in c:
            c["check_units"] = 2

    for name in os.listdir(pb / "cells"):
        _edit(pb / "cells" / name, cell)
    return str(root)
