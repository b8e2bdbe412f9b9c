"""elementwise_ms.train (ms): device time of elementwise and reduction kernels
(casts, the GroupNorm chain, SiLU, softmaxes) a training step. Moves imgs_per_s."""

from portbench import layers


def read(view):
    return layers.kinds_ms(view, "train", "elementwise", "reduction")
