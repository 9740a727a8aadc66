"""`encoder_update_ms`: host milliseconds a distillation step spends in
the program's `distill.optimizer` range (Adam over the encoder's leaves),
on the profiler's clock in the traced units. None without such a range."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "distill.optimizer")
