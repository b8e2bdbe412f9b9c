"""launches.train (launches): device operations a training step in the trace. Moves
imgs_per_s."""

from portbench import layers


def read(view):
    return layers.launches(view, "train")
