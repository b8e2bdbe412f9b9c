"""mfu.serve (%): the whole served request's operations (counts/model.py) times the
units of the measured window over its seconds, as a share of the card's
dense peak at the cell's precision. Moves request_ms_p50."""

from portbench import layers


def read(view):
    return layers.mfu(view, "serve")
