"""`first_guess_ms`: the host-clock milliseconds a step of the `first_guess` span takes in
the traced run's window, each span between device synchronizes."""


def read(run):
    return run.spans.ms("first_guess")
