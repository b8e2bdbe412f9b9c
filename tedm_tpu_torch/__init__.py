"""tedm_tpu_torch: the TEDM family in PyTorch, with hand-written CUDA kernels
for the NVIDIA H100.

A port of ``tedm_tpu`` (JAX on TPU), which stays the reference. It imports
nothing from ``tedm_tpu`` or JAX; its tests hold each module against its JAX
counterpart. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.
"""

from tedm_tpu_torch.config import Config

__all__ = ["Config"]
