"""The data-parallel world of a fine-tune, from the environment (JAX:
parallel/mesh.py).

The JAX package shards the batch over the ``data`` axis of a
``jax.sharding.Mesh`` and lets XLA insert the gradient psum.  The port runs
torch's idiom instead: one process a card, joined by ``torch.distributed``
(``parallel/distributed.py``), each loading its own block of the global
batch's rows and summing the gradients with one all-reduce.  This module
says how many such processes a host runs:

* ``EASEVOICE_DP`` (``data_parallel_mesh``, ``mesh.py:110-133``): ``auto``
  (the default) uses every visible card; one card, or the CPU, gives no
  world, and the single-process path runs unchanged.  ``N`` asks for a
  world of N ranks (split evenly over the hosts of
  ``EASEVOICE_NUM_PROCESSES``, at most the visible cards a host), on the
  CPU too, where each rank is a process on the host.  ``off`` (or ``0``,
  ``1``, ``none``) turns it off.  ``CUDA_VISIBLE_DEVICES`` chooses the
  cards.
* ``EASEVOICE_TP`` (``train_mesh``, ``mesh.py:72-103``): tensor
  parallelism over the GPT's heads and FFN (the JAX package's
  ``parallel/gpt_sharding.py``).  It is not ported: a value above 1 raises
  rather than being ignored.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

DP_FLAG = "EASEVOICE_DP"
TP_FLAG = "EASEVOICE_TP"
HOSTS_FLAG = "EASEVOICE_NUM_PROCESSES"


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name, "").strip()
    return int(val) if val else default


def local_batch_multiple(world_size: int) -> int:
    """Global batch sizes must be a multiple of this: the world's size."""
    return max(int(world_size), 1)


def wrap_pad_indices(idxs: Sequence[int], multiple: int) -> list:
    """Pad a batch's example indices to a multiple by wrapping.

    The reference's DistributedBucketSampler does exactly this to even out
    DDP batches (data_utils.py:229-324): repeated samples, not dropped
    ones, so every clip trains every epoch."""
    idxs = list(idxs)
    if multiple <= 1 or len(idxs) % multiple == 0:
        return idxs
    need = (-len(idxs)) % multiple
    return idxs + [idxs[i % len(idxs)] for i in range(need)]


def check_tensor_parallel() -> None:
    """Raises when ``EASEVOICE_TP`` asks for tensor parallelism, which the
    port does not have yet."""
    tp = _env_int(TP_FLAG, 1)
    if tp > 1:
        raise NotImplementedError(
            f"{TP_FLAG}={tp}: tensor parallelism of the GPT (the JAX "
            f"package's parallel/gpt_sharding.py) is not ported yet; it is "
            f"the next item of ROADMAP.md section 1.  Unset {TP_FLAG} (or "
            f"set it to 1) to train data-parallel")


def data_parallel_world(device: str = "cuda") -> Optional[int]:
    """The ranks this host runs for a fine-tune on ``device`` ("cuda" or
    "cpu"), one a card, or None when the world would be one process (the
    single-process path).  Reads ``EASEVOICE_DP`` as the module note says;
    raises for ``EASEVOICE_TP`` > 1."""
    check_tensor_parallel()
    val = os.environ.get(DP_FLAG, "auto").strip().lower()
    if val in ("off", "none", "0", "1"):
        return None
    hosts = max(_env_int(HOSTS_FLAG, 1), 1)
    cuda = device.startswith("cuda")
    if val == "auto":
        if not cuda:
            return None
        import torch

        local = torch.cuda.device_count()
    else:
        local = max(int(val) // hosts, 1)
        if cuda:
            import torch

            local = min(local, torch.cuda.device_count())
    return local if local >= 1 and local * hosts > 1 else None
