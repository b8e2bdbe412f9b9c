"""idle_share.serve (%): share of the measured window in which no device
operation runs, busy time from the traced units. Moves request_ms_p50."""

from portbench import layers


def read(view):
    return layers.idle_share(view, "serve")
