"""conv_ms.serve (ms): device time of convolution and GEMM kernels (cuDNN,
cuBLAS) a served request. Moves request_ms_p50."""

from portbench import layers


def read(view):
    return layers.kinds_ms(view, "serve", "conv")
