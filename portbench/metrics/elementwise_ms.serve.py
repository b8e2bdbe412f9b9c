"""elementwise_ms.serve (ms): device time of elementwise and reduction kernels
(casts, the GroupNorm chain, SiLU, softmaxes) a served request. Moves request_ms_p50."""

from portbench import layers


def read(view):
    return layers.kinds_ms(view, "serve", "elementwise", "reduction")
