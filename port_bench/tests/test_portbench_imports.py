"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: a subprocess imports
every module under port_bench/ with the whole top-level names blocked."""

import subprocess
import sys

from conftest import ROOT

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_from_image_tpu")

SCRIPT = r"""
import importlib, importlib.abc, importlib.util, os, sys
blocked = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
base = sys.argv[2]
sys.path.insert(0, os.getcwd())
n = 0
for dirpath, _, files in os.walk(os.path.join("port_bench", base)):
    if "tests" in dirpath.split(os.sep):
        continue
    for f in sorted(files):
        if f.endswith(".py"):
            path = os.path.join(dirpath, f)
            spec = importlib.util.spec_from_file_location(f"_checked_{n}", path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = module
            spec.loader.exec_module(module)
            n += 1
print("loaded", n)
"""


def _import_all(base, blocked):
    return subprocess.run([sys.executable, "-c", SCRIPT, ",".join(blocked), base], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_benchmark_imports_no_jax():
    out = _import_all("", BLOCKED)
    assert out.returncode == 0, out.stderr[-3000:]


def test_reference_imports_nothing_of_the_program():
    out = _import_all("reference", BLOCKED + ("nerf_from_image_tpu_torch",))
    assert out.returncode == 0, out.stderr[-3000:]
