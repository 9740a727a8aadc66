"""`regularizer_ms`: host milliseconds a training iteration spends in the
program's `gan.regularizers` ranges (eikonal, TV and entropy, path length,
and R1's gradient with its graph), on the profiler's clock in the traced
units. None without such ranges."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "gan.regularizers")
