"""K3's (the fused RHT's) share of its roofline in the device capture: the
bounds of its launches at the engine's batch rows (two a packed linear)
over their device time."""
from benchmark import readers as R


def read(run):
    return R.kernel_roofline(run, "k3")
