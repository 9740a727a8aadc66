"""`elementwise_ms`: device milliseconds of PyTorch's own kernels
(elementwise, reduction, index, gather and copy kernels, `at::native`)
per step of the traced units, by kernel name."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return 1e3 * t.time_s(lambda name: "at::native" in name) / (t.units * run.steps_per_unit)
