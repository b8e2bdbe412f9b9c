"""The plain reference of the benchmark's configurations: fp32 PyTorch with
no kernel, cache or batching of the program's, and nothing imported from
it. It decides ``correct``."""

import torch


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 in cuDNN's convolutions or in matrix
    products, which the card would otherwise allow."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
