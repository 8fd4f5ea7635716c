"""The share of the device capture (the window's last trace_s seconds,
CUDA activity alone) in which no operation ran on the card: 1 - the union
of the device spans over the captured seconds."""
from benchmark import readers as R


def read(run):
    return R.idle_share(run)
