"""K1-tile's share of its roofline in the device capture: the bounds of
its launches at the window's rows over the device time of its kernels
(dm_prep, dm_tile, dm_tile_finish)."""
from benchmark import readers as R


def read(run):
    return R.kernel_roofline(run, "k1_tile")
