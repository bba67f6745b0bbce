"""The data-parallel process group of the fine-tunes (JAX:
parallel/distributed.py).

Environment contract, the JAX package's (``distributed.py:11-16``):

``EASEVOICE_COORDINATOR``    ``host:port`` of process 0's rendezvous.
``EASEVOICE_NUM_PROCESSES``  the hosts (one launching process each).
``EASEVOICE_PROCESS_ID``     this host's index.

In JAX these count hosts, one process each, and a host's process drives all
of its devices.  The port runs torch's idiom, one process a card:
:func:`launch` starts a host's ranks (``parallel/mesh.py
data_parallel_world`` says how many) and hands each its local index, so

    world size = hosts x cards used a host,
    rank       = EASEVOICE_PROCESS_ID x cards used a host + local index.

On one host with no coordinator given, :func:`launch` picks a free port on
``127.0.0.1``.

Batch semantics, as in JAX: every rank builds the same seeded bucket
schedule, pads each batch to a multiple of the world by wrapping
(``mesh.wrap_pad_indices``) and loads only the contiguous block of rows
that JAX's ``NamedSharding(mesh, P("data"))`` gives the device in its
position (:func:`process_local_rows`).  Each rank's loss is its share of
the global batch's, so the gradients are summed, never averaged
(:func:`reduce_gradients`), and a rank's metrics are shares summed across
the world (:func:`sum_across_ranks`).

Nothing falls back: a failed rendezvous or collective raises, and a failed
rank fails :func:`launch`.  NCCL serves ranks on CUDA cards, gloo the CPU;
a caller that wants gloo on the card (two ranks sharing one card, which
NCCL refuses) passes ``backend="gloo"``.
"""
from __future__ import annotations

import os
import pickle
import queue as queue_mod
import socket
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

from ..nn.layers import BatchRows
from .mesh import HOSTS_FLAG

COORDINATOR_FLAG = "EASEVOICE_COORDINATOR"
PROCESS_ID_FLAG = "EASEVOICE_PROCESS_ID"
# set by launch for each rank it starts
LOCAL_RANK_FLAG = "EASEVOICE_LOCAL_RANK"
LOCAL_WORLD_FLAG = "EASEVOICE_LOCAL_WORLD_SIZE"


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name, "").strip()
    return int(val) if val else None


def _dist():
    import torch.distributed as dist

    return dist


def initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(device: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Join the data-parallel world if this process is one of its ranks;
    idempotent.  Returns True when a process group is up after the call.

    A rank is a process :func:`launch` started (its local index in
    ``EASEVOICE_LOCAL_RANK``), or the one process of a host when
    ``EASEVOICE_NUM_PROCESSES`` > 1 names more hosts than one.  Anything
    else is the single-process path: no group, nothing changes.
    ``backend``: NCCL for CUDA ranks and gloo on the CPU unless given; an
    NCCL rank is bound to ``cuda:<local index>``."""
    if initialized():
        return True
    hosts = _env_int(HOSTS_FLAG) or 1
    local = _env_int(LOCAL_RANK_FLAG)
    n_local = _env_int(LOCAL_WORLD_FLAG) or 1
    if local is None:
        if hosts <= 1:
            return False
        local, n_local = 0, 1
    coordinator = os.environ.get(COORDINATOR_FLAG, "").strip()
    process_id = _env_int(PROCESS_ID_FLAG)
    if not coordinator or (hosts > 1 and process_id is None):
        raise RuntimeError(
            f"a data-parallel rank needs {COORDINATOR_FLAG} (host:port of "
            f"process 0) and, with {HOSTS_FLAG} > 1, {PROCESS_ID_FLAG}")
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local)
    _dist().init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=hosts * n_local, rank=(process_id or 0) * n_local + local)
    return True


def world_size() -> int:
    return _dist().get_world_size() if initialized() else 1


def rank() -> int:
    return _dist().get_rank() if initialized() else 0


def local_rank() -> int:
    """This rank's index among its host's ranks (0 outside a world)."""
    return _env_int(LOCAL_RANK_FLAG) or 0


def is_primary() -> bool:
    """True on the rank that writes checkpoints, exports, connector lines,
    session data and TensorBoard (rank 0), as the reference's rank == 0
    guards (src/train/sovits.py:242-258)."""
    return rank() == 0


def rank_device(device: str) -> torch.device:
    """The device a fine-tune's rank runs on: ``cuda:<local index>`` for a
    CUDA rank of a world, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and initialized():
        return torch.device("cuda", local_rank())
    return dev


def process_local_rows(n_rows: int, world: Optional[int] = None,
                       rank_: Optional[int] = None) -> List[int]:
    """Global row indices of an ``n_rows`` batch that rank ``rank_`` of a
    world of ``world`` loads (the process group's by default): the
    contiguous block JAX's ``NamedSharding(mesh, P("data"))`` gives the
    device in that position of the data axis (``distributed.py:103-120``).
    ``n_rows`` must be a multiple of the world (``mesh.wrap_pad_indices``).
    Outside a world, every row."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    if n_rows % world:
        raise ValueError(f"process_local_rows: {n_rows} rows do not split "
                         f"over a world of {world}; wrap-pad the batch first")
    n = n_rows // world
    return list(range(rank_ * n, (rank_ + 1) * n))


def batch_rows(n_rows: int) -> Optional[BatchRows]:
    """Where this rank's rows of an ``n_rows`` global batch sit, for the
    steps and the draws (None outside a world: the single-process path)."""
    if not initialized():
        return None
    return BatchRows(process_local_rows(n_rows)[0], n_rows)


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> int:
    """Sums the gradients of ``params`` over the world: one SUM all-reduce
    of the fp32 gradients flattened into one bucket (the parameters of one
    optimizer), written back in place.  The parameters that hold a
    gradient are the same on every rank (the graph does not depend on the
    data).  Returns the bytes reduced (0 outside a world)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not initialized() or not grads:
        return 0
    if any(g.dtype != torch.float32 for g in grads):
        raise ValueError("reduce_gradients: the gradients must be fp32")
    flat = torch.cat([g.reshape(-1) for g in grads])
    _dist().all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat.numel() * flat.element_size()


def sum_across_ranks(values: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """0-d fp32 tensors summed over the world in one all-reduce (shares of
    global-batch metrics, counts); the values as given outside a world."""
    if not initialized() or not values:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in
                        values.values()])
    _dist().all_reduce(flat)
    return dict(zip(values, flat.unbind()))


# ---- launching a host's ranks -----------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, local: int, n_local: int, coordinator: str,
               device: str, backend: Optional[str], results) -> None:
    """One rank: joins the world, runs ``fn(*args)`` and sends back (local
    index, ok, pickled result or traceback)."""
    os.environ[LOCAL_RANK_FLAG] = str(local)
    os.environ[LOCAL_WORLD_FLAG] = str(n_local)
    os.environ[COORDINATOR_FLAG] = coordinator
    dist = _dist()
    try:
        maybe_initialize(device, backend)
        out = fn(*args)
        dist.barrier()
        results.put((local, True, pickle.dumps(out)))
    except BaseException:
        results.put((local, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], args: Sequence[Any], n_local: int,
           device: str = "cuda", backend: Optional[str] = None
           ) -> List[Any]:
    """Runs ``fn(*args)`` on ``n_local`` ranks of this host, each a process
    of its own (the ``spawn`` start method; ``fn`` a module-level
    function) that has joined the world (:func:`maybe_initialize` with
    ``device`` and ``backend``), and returns their results in local order.
    Results cross the process boundary pickled.  A rank that raises or dies
    stops the others and makes this raise, with its traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    coordinator = os.environ.get(COORDINATOR_FLAG, "").strip() or \
        f"127.0.0.1:{free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, tuple(args), i, n_local, coordinator, device, backend, results),
        name=f"easevoice-rank-{i}") for i in range(n_local)]
    for p in procs:
        p.start()
    got: Dict[int, bytes] = {}
    failure = None
    try:
        while len(got) < n_local and failure is None:
            try:
                # a rank that dies without a word is found between polls
                local, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    failure = (f"rank {dead[0]} of {n_local} exited with "
                               f"code {procs[dead[0]].exitcode}")
                continue
            if ok:
                got[local] = payload
            else:
                failure = f"rank {local} of {n_local} failed:\n{payload}"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"launch: {failure}")
    bad = [i for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"launch: rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode}")
    return [pickle.loads(got[i]) for i in range(n_local)]
