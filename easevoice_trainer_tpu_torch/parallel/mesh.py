"""The training world of a fine-tune, from the environment (JAX:
parallel/mesh.py).

The JAX package shards the batch over the ``data`` axis of a
``jax.sharding.Mesh`` and the s1 GPT's heads and FFN over its ``model``
axis, and lets XLA insert the collectives.  The port runs torch's idiom
instead: one process a card, joined by ``torch.distributed``
(``parallel/distributed.py``), each loading its own block of the global
batch's rows and holding its shard of the GPT (``parallel/gpt_sharding.py``).
This module says how many such processes there are:

* ``EASEVOICE_DP`` (``data_parallel_mesh``, ``mesh.py:110-133``): ``auto``
  (the default) uses every visible card; one card, or the CPU, gives no
  world, and the single-process path runs unchanged.  ``N`` asks for a
  world of N ranks (split evenly over the hosts of
  ``EASEVOICE_NUM_PROCESSES``, at most the visible cards a host), on the
  CPU too, where each rank is a process on the host.  ``off`` (or ``0``,
  ``1``, ``none``) turns it off.  ``CUDA_VISIBLE_DEVICES`` chooses the
  cards.  Both fine-tunes read it (:func:`data_parallel_world`).
* ``EASEVOICE_TP`` (``train_mesh``, ``mesh.py:72-103``): tensor
  parallelism over the s1 GPT's heads and FFN, read by the s1 fine-tune
  alone (:func:`train_world`; the s2 fine-tune ignores it, as JAX's s2
  trainer calls ``data_parallel_mesh``).  :func:`train_grid` is JAX's
  ``train_mesh`` over a pool of devices: ``n_model = min(TP, pool)``, below
  2 the data-parallel world, else ``n_data`` from ``pool // n_model``
  (``auto`` all of it, ``off`` 1, ``N`` at most N).  On CUDA the pool is
  the visible cards times the hosts of ``EASEVOICE_NUM_PROCESSES``.  On the
  CPU a rank is a process, so the pool is what is asked for: ``n_model =
  TP`` and ``n_data`` = N for ``EASEVOICE_DP=N``, 1 for ``auto`` or
  ``off`` (as ``EASEVOICE_DP=N`` counts ranks on the CPU).

Ranks sit on the grid as JAX's ``make_mesh`` places devices: global rank
``d * n_model + m`` is at data index d and model index m.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

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


def data_parallel_world(device: str = "cuda") -> Optional[int]:
    """The ranks this host runs for a fine-tune on ``device`` ("cuda" or
    "cpu"), one a card, or None when the world would be one process (the
    single-process path).  Reads ``EASEVOICE_DP`` as the module note says,
    and never ``EASEVOICE_TP``."""
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


Grid = Tuple[int, int]


def _tp_flag() -> int:
    """``EASEVOICE_TP`` as JAX reads it: an integer, else 1."""
    try:
        return int(os.environ.get(TP_FLAG, "1") or "1")
    except ValueError:
        return 1


def _data_grid(n_devices: int, dp: str) -> Optional[Grid]:
    """JAX's ``data_parallel_mesh`` over an accelerator pool of
    ``n_devices``: (n, 1), or None for no mesh."""
    dp = dp.strip().lower()
    if dp in ("off", "none", "0", "1"):
        return None
    n = n_devices if dp == "auto" else min(int(dp), n_devices)
    return (n, 1) if n >= 2 else None


def train_grid(n_devices: int, dp: str, tp: int) -> Optional[Grid]:
    """(n_data, n_model) of JAX's ``train_mesh`` over a pool of
    ``n_devices`` accelerators, ``dp`` and ``tp`` as ``EASEVOICE_DP`` and
    ``EASEVOICE_TP`` give them; None where it gives no mesh."""
    n_model = min(tp, n_devices)
    if tp <= 1 or n_model < 2:
        return _data_grid(n_devices, dp)
    dp = dp.strip().lower()
    avail = n_devices // n_model
    if dp in ("off", "none", "0"):
        n_data = 1
    elif dp == "auto":
        n_data = max(avail, 1)
    else:
        n_data = max(min(int(dp), avail), 1)
    return n_data, n_model


def train_world(device: str = "cuda") -> Optional[Grid]:
    """The s1 fine-tune's grid (n_data, n_model) of ranks over all hosts,
    or None for a world of one process.  ``EASEVOICE_TP`` <= 1, or a pool
    below two devices, falls back to :func:`data_parallel_world` (as
    ``train_mesh`` falls back to ``data_parallel_mesh``), whose ranks make
    a grid (ranks x hosts, 1)."""
    tp = _tp_flag()
    dp = os.environ.get(DP_FLAG, "auto")
    hosts = max(_env_int(HOSTS_FLAG, 1), 1)
    if device.startswith("cuda"):
        import torch

        grid = train_grid(torch.cuda.device_count() * hosts, dp, tp)
    elif tp > 1:
        val = dp.strip().lower()
        n_data = 1 if val in ("auto", "off", "none", "0") else int(val)
        grid = train_grid(tp * max(n_data, 1), dp, tp)
    else:
        grid = None
    if grid is None or grid[1] == 1:
        ranks = data_parallel_world(device)
        return None if ranks is None else (ranks * hosts, 1)
    if (grid[0] * grid[1]) % hosts:
        raise ValueError(f"train_world: a grid of {grid[0]} x {grid[1]} "
                         f"ranks does not split over {hosts} hosts")
    return grid


def host_ranks(grid: Grid) -> int:
    """The ranks of ``grid`` that this host runs (the grid split evenly
    over the hosts of ``EASEVOICE_NUM_PROCESSES``)."""
    return grid[0] * grid[1] // max(_env_int(HOSTS_FLAG, 1), 1)
