"""`backward_ms`: host milliseconds a training iteration spends in the
program's `gan.backward` ranges (each parameter gradient of the G and D
steps: autograd's backward, the plane-gradient kernel's launches inside),
on the profiler's clock in the traced units. None without such ranges."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "gan.backward")
