"""Data- and tensor-parallel training over ``torch.distributed`` (JAX:
parallel/): the world and the grid from the environment (``mesh.py``), the
process groups, the row split, the reductions and the launcher
(``distributed.py``), and the s1 GPT's tensor-parallel shards
(``gpt_sharding.py``)."""
from . import distributed
from .mesh import (
    data_parallel_world,
    host_ranks,
    local_batch_multiple,
    train_grid,
    train_world,
    wrap_pad_indices,
)
