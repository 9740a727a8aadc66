"""`peak_gib`: the device memory allocated at its peak in the window
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(run):
    return run.window_peak_bytes / 2**30
