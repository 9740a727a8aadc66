"""The two sides a driver can run: the program under test (the port) and
the benchmark's frozen plain reference, behind one set of names, and the
weights both take, made from the seed.

A driver calls only `Side` attributes, so the control (the reference in
the program's place, at a lower precision) and the fault checks (the
program with a broken part) run the same driver code as the benchmark.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

PROGRAM = "nerf_from_image_tpu_torch"
REFERENCE = "port_bench.reference"


class Side:
    """The modules and functions of one side. `plane_splat` is the render
    setting the side runs: the program its plane-gradient kernel, the
    reference autograd's gradient of the gather."""

    def __init__(self, package: str):
        self.package = package
        self.is_program = package == PROGRAM

        def load(name):
            return importlib.import_module(f"{package}.{name}")

        self.render = load("engine.render")
        self.inversion = load("engine.inversion")
        self.evaluate = load("engine.evaluate")
        self.gan = load("engine.gan")
        self.generator = load("models.generator")
        self.encoder = load("models.encoder")
        self.lpips = load("models.lpips")
        self.discriminator = load("models.discriminator")
        self.pnp = load("pose.pnp")
        self.first_guess = (load("invert") if self.is_program else load("first_guess")).first_guess
        self.splat = load("kernels.splat") if self.is_program else None
        self.plane_splat = self.is_program

    def k1_launches(self):
        """The program's count of plane-gradient kernel launches (None on
        the reference, which has no such kernel)."""
        return None if self.splat is None else self.splat.splat3_backward.launches


def program() -> Side:
    return Side(PROGRAM)


def reference() -> Side:
    return Side(REFERENCE)


def seeded_generator(device, *key: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from the integer tuple `key`
    (a seed of any size and the indices under it). On the meta device,
    where nothing is drawn, None."""
    if torch.device(device).type == "meta":
        return None
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & (2**63 - 1))


def build(side: Side, make, seed_key, device) -> torch.nn.Module:
    """The module `make(side, device, generator)` builds, with the weights
    of the reference's module built on `device` from a generator seeded by
    `seed_key`: the benchmark's input, handed alike to both sides. The
    program builds its own module, constants included, and takes the
    weights through its `load_state_dict` (parameters and persistent
    buffers, the form a checkpoint has), as it would take a checkpoint."""
    if torch.device(device).type == "meta":
        with torch.device("meta"):
            return make(side, torch.device("meta"), None)
    ref = reference() if side.is_program else side
    with torch.device(device):
        weights = make(ref, device, seeded_generator(device, *seed_key))
    if not side.is_program:
        return weights
    with torch.device(device):
        module = make(side, device, seeded_generator(device, *seed_key))
    module.load_state_dict(weights.state_dict())
    return module
