"""`optimizer_ms`: host milliseconds a training iteration spends in the
program's `gan.optimizer` ranges (the optimizers' clip and Adam, the SDF
clamp, the EMA update and the gradient-norm metric of the G and D steps),
on the profiler's clock in the traced units. None without such ranges."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "gan.optimizer")
