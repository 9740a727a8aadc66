"""`eval_ms`: the host-clock milliseconds a step of the `eval` span takes in
the traced run's window, each span between device synchronizes."""


def read(run):
    return run.spans.ms("eval")
