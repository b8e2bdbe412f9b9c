"""launches.serve (launches): device operations a served request in the trace. Moves
request_ms_p50."""

from portbench import layers


def read(view):
    return layers.launches(view, "serve")
