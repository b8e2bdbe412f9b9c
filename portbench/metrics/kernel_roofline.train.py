"""kernel_roofline.train (%): the port's own kernels' share of their bound
(counts/kernels.py) over the traced units, by device time. Moves imgs_per_s."""

from portbench import layers


def read(view):
    return layers.kernel_roofline(view, "train")
