"""conv_ms.train (ms): device time of convolution and GEMM kernels (cuDNN,
cuBLAS) a training step. Moves imgs_per_s."""

from portbench import layers


def read(view):
    return layers.kinds_ms(view, "train", "conv")
