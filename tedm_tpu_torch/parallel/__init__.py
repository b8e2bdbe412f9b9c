"""Data, tensor and spatial parallelism over ``torch.distributed`` (port of
``tedm_tpu/parallel``, its ``data``, ``model`` and ``spatial`` axes): see
``mesh``, ``tensor_parallel`` and ``spatial``."""

from tedm_tpu_torch.parallel.mesh import (
    DataParallel,
    data_parallel_setup,
    init_multihost,
    make_mesh,
    param_shardings,
)
