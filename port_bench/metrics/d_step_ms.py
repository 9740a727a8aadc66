"""`d_step_ms`: the host-clock milliseconds a step of the `d_step` span takes in
the traced run's window, each span between device synchronizes."""


def read(run):
    return run.spans.ms("d_step")
