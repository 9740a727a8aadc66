"""`k1_roofline`: the plane-gradient kernel's share of its roofline in
the traced units: its bound for the units' points and planes (the cell's
count `k1_bound_ms_per_unit`, from counts/k1.py) over the device time of
the kernels that implement it (named `splat3`). None when no such kernel
ran."""


def read(run):
    t = run.trace
    if t is None or t.count("splat3") == 0:
        return None
    bound_s = run.cell["counts"]["k1_bound_ms_per_unit"] * 1e-3 * t.units
    return 100.0 * bound_s / t.time_s(lambda name: "splat3" in name)
