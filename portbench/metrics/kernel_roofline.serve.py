"""kernel_roofline.serve (%): the port's own kernels' share of their bound
(counts/kernels.py) over the traced units, by device time. Moves request_ms_p50."""

from portbench import layers


def read(view):
    return layers.kernel_roofline(view, "serve")
