"""The command refuses to run without a card, and in a directory that
holds only BENCHMARK.json and the benchmark."""

import os
import shutil
import subprocess
import sys

from conftest import ROOT

ARGS = ["-m", "port_bench.run", "--workload", "p3d_car-invert-hybrid-b8", "--seed",
        "2147483659", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + ARGS, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_refuses_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_refuses_with_the_benchmark_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
