"""K1-decode's share of its roofline in the device capture: its launches'
bounds (bytes of the 2-bit planes, x and y at the engine's batch rows,
over 3.35 TB/s) over their device time."""
from benchmark import readers as R


def read(run):
    return R.kernel_roofline(run, "k1_decode")
