"""K2's (the flash prefill's) share of its roofline in the device capture:
causal attention over the window's tokens, its bound over its device
time."""
from benchmark import readers as R


def read(run):
    return R.kernel_roofline(run, "k2")
