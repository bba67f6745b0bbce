"""Data-parallel training over ``torch.distributed`` (JAX: parallel/):
the world from the environment (``mesh.py``) and the process group, the
row split, the gradient and metric reductions and the launcher
(``distributed.py``)."""
from . import distributed
from .mesh import (
    data_parallel_world,
    local_batch_multiple,
    wrap_pad_indices,
)
