"""The program's five kernels' least time over their device time, in the
traced slice (yardstick.forward_bound_s)."""

from portbench import readings


def read(r):
    return readings.kernels_roofline_pct(r)
