"""`device_idle_pct`: the share of the traced window in which no
operation ran on the device."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
