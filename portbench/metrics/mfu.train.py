"""mfu.train (%): the whole training step's operations (counts/model.py) times the
units of the measured window over its seconds, as a share of the card's
dense peak at the cell's precision. Moves imgs_per_s."""

from portbench import layers


def read(view):
    return layers.mfu(view, "train")
