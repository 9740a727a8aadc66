"""`render_ms`: host milliseconds a training iteration spends in the
program's `render.*` ranges (synthesis, coarse pass, fine pass,
compositing; the G step's render and the D step's no-grad one), on the
profiler's clock in the traced units. None without such ranges."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "render")
