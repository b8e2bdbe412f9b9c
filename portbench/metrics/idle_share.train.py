"""idle_share.train (%): share of the measured window in which no device
operation runs, busy time from the traced units. Moves imgs_per_s."""

from portbench import layers


def read(view):
    return layers.idle_share(view, "train")
