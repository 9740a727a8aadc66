"""`encoder_ms`: host milliseconds a distillation step spends in the
program's `distill.encoder` range (the MiT-B5 encoder's forward with drop
path and the three losses), on the profiler's clock in the traced units.
None without such a range."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "distill.encoder")
