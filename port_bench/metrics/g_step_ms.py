"""`g_step_ms`: the host-clock milliseconds a step of the `g_step` span takes in
the traced run's window, each span between device synchronizes."""


def read(run):
    return run.spans.ms("g_step")
