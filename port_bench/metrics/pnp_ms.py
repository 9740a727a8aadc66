"""`pnp_ms`: host milliseconds a batch spends in the program's
`first_guess.pnp` range (PnP over the focal guesses on the encoder's
coordinate map), on the profiler's clock in the traced units. None
without such a range."""

from port_bench.ranges import host_ms


def read(run):
    return host_ms(run, "first_guess.pnp")
