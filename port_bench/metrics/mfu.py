"""`mfu`: the whole step's share of the card's peak: the model FLOPs of
the work completed in the traced run's window (the cell's count
`flops_per_unit`, from counts/flops.py, times the units) over the
window's seconds and the peak rate of the configuration's precision."""


def read(run):
    peak = run.peaks["flops"][run.config["precision"]["peak"]]
    flops = run.cell["counts"]["flops_per_unit"] * run.units
    return 100.0 * flops / run.window_s / peak
