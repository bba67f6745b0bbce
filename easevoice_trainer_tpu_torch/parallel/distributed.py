"""The process groups of the fine-tunes (JAX: parallel/distributed.py).

Environment contract, the JAX package's (``distributed.py:11-16``):

``EASEVOICE_COORDINATOR``    ``host:port`` of process 0's rendezvous.
``EASEVOICE_NUM_PROCESSES``  the hosts (one launching process each).
``EASEVOICE_PROCESS_ID``     this host's index.

In JAX these count hosts, one process each, and a host's process drives all
of its devices.  The port runs torch's idiom, one process a card:
:func:`launch` starts a host's ranks (``parallel/mesh.py
data_parallel_world`` and ``train_world`` say how many) and hands each its
local index, so

    world size = hosts x cards used a host,
    rank       = EASEVOICE_PROCESS_ID x cards used a host + local index.

On one host with no coordinator given, :func:`launch` picks a free port on
``127.0.0.1``.

The grid (the s1 fine-tune under ``EASEVOICE_TP``): :func:`launch` tells
its ranks the model axis's size n_model (``EASEVOICE_MODEL_RANKS``), and
rank r sits at data index ``r // n_model`` and model index ``r % n_model``,
as JAX's ``make_mesh`` places device ``d * n_model + m``.  The model group
is the n_model consecutive ranks of one data index, the data group the
ranks of one model index; every rank creates every group, in the same
order (gloo and NCCL hang otherwise).  With n_model = 1 (data parallelism
alone) there is no model group and the data group is the world.

Batch semantics, as in JAX: every rank builds the same seeded bucket
schedule, pads each batch to a multiple of the data axis by wrapping
(``mesh.wrap_pad_indices``) and loads only the contiguous block of rows
that JAX's ``NamedSharding(mesh, P("data"))`` gives the devices at its data
index (:func:`process_local_rows`): every model rank of one data index
loads the same rows.  Each data index's loss is its share of the global
batch's, so the gradients are summed over the data group, never averaged
(:func:`reduce_gradients`), and a rank's metrics are shares summed over
the data group (:func:`sum_across_ranks`; over the world they would count
each share n_model times).

Nothing falls back: a failed rendezvous or collective raises, and a failed
rank fails :func:`launch`.  NCCL serves ranks on CUDA cards, gloo the CPU;
a caller that wants gloo on the card (ranks sharing one card, which NCCL
refuses) passes ``backend="gloo"``.
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
MODEL_RANKS_FLAG = "EASEVOICE_MODEL_RANKS"

# the grid's groups of this process's world: (n_model, the model group,
# the data group); None outside a world
_grid = None


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
    dist = _dist()
    world = hosts * n_local
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world,
        rank=(process_id or 0) * n_local + local)
    _make_groups(world, _env_int(MODEL_RANKS_FLAG) or 1)
    return True


def _make_groups(world: int, n_model: int) -> None:
    """The grid's model and data groups; every rank creates all of them in
    one order."""
    global _grid
    if world % n_model:
        raise ValueError(f"a world of {world} ranks has no grid with a "
                         f"model axis of {n_model}")
    if n_model == 1:
        _grid = (1, None, None)
        return
    dist = _dist()
    my_d, my_m = grid_position(dist.get_rank(), n_model)
    model = data = None
    for d in range(world // n_model):
        g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
        if d == my_d:
            model = g
    for m in range(n_model):
        g = dist.new_group(list(range(m, world, n_model)))
        if m == my_m:
            data = g
    _grid = (n_model, model, data)


def destroy() -> None:
    """Leaves the world (and forgets its groups)."""
    global _grid
    if initialized():
        _dist().destroy_process_group()
    _grid = None


def world_size() -> int:
    return _dist().get_world_size() if initialized() else 1


def rank() -> int:
    return _dist().get_rank() if initialized() else 0


def model_size() -> int:
    """n_model, the size of the grid's model axis (1 outside a world or
    without tensor parallelism)."""
    return _grid[0] if initialized() and _grid is not None else 1


def grid_position(rank_: int, n_model: int):
    """(data index, model index) of global rank ``rank_`` on a grid with a
    model axis of ``n_model``, JAX's ``make_mesh`` placement."""
    return divmod(rank_, n_model)


def model_rank() -> int:
    """This rank's model index."""
    return grid_position(rank(), model_size())[1]


def data_size() -> int:
    """n_data, the size of the grid's data axis."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's data index."""
    return grid_position(rank(), model_size())[0]


def model_group():
    """The model group of this rank (None without one)."""
    return _grid[1] if initialized() and _grid is not None else None


def data_group():
    """The data group of this rank (None: the world)."""
    return _grid[2] if initialized() and _grid is not None else None


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
    """Global row indices of an ``n_rows`` batch that data index
    ``rank_`` of a data axis of ``world`` loads (this rank's by default):
    the contiguous block JAX's ``NamedSharding(mesh, P("data"))`` gives the
    devices in that position of the data axis (``distributed.py:103-120``).
    ``n_rows`` must be a multiple of the data axis
    (``mesh.wrap_pad_indices``).  Outside a world, every row."""
    world = data_size() if world is None else world
    rank_ = data_rank() if rank_ is None else rank_
    if n_rows % world:
        raise ValueError(f"process_local_rows: {n_rows} rows do not split "
                         f"over a world of {world}; wrap-pad the batch first")
    n = n_rows // world
    return list(range(rank_ * n, (rank_ + 1) * n))


def batch_rows(n_rows: int) -> Optional[BatchRows]:
    """Where this rank's rows of an ``n_rows`` global batch sit, and its
    column block (its model index of n_model), for the steps and the draws
    (None outside a world: the single-process path)."""
    if not initialized():
        return None
    return BatchRows(process_local_rows(n_rows)[0], n_rows, model_rank(),
                     model_size())


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> int:
    """Sums the gradients of ``params`` over the data group: one SUM
    all-reduce of the fp32 gradients flattened into one bucket (the
    parameters of one optimizer), written back in place.  The parameters
    that hold a gradient are the same on every rank (the graph does not
    depend on the data).  Returns the bytes reduced (0 outside a world or
    where a model axis leaves a data axis of one)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not initialized() or _lone_data_rank() or not grads:
        return 0
    if any(g.dtype != torch.float32 for g in grads):
        raise ValueError("reduce_gradients: the gradients must be fp32")
    flat = torch.cat([g.reshape(-1) for g in grads])
    _dist().all_reduce(flat, group=data_group())
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat.numel() * flat.element_size()


def sum_across_ranks(values: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """0-d fp32 tensors summed over the data group in one all-reduce
    (shares of global-batch metrics, counts); the values as given outside a
    world or where a model axis leaves a data axis of one."""
    if not initialized() or _lone_data_rank() or not values:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in
                        values.values()])
    _dist().all_reduce(flat, group=data_group())
    return dict(zip(values, flat.unbind()))


def _lone_data_rank() -> bool:
    """A grid with a model axis and a data axis of one: the data group is
    this rank alone and its sums are copies.  (A data-parallel world of one
    rank still reduces: its collective is the backend's own check.)"""
    return model_size() > 1 and data_size() == 1


def all_reduce_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, in place (unchanged without
    one); returns ``t``."""
    if model_size() > 1:
        _dist().all_reduce(t, group=model_group())
    return t


def gather_model(t: torch.Tensor) -> List[torch.Tensor]:
    """The model group's n_model tensors of ``t``'s shape, in model order
    (every rank of the group gets all of them): the shards of one
    parameter or state tensor, for the whole tensor that a resume file or
    an export holds (``gpt_sharding.gather_state_dicts``).  ``[t]``
    without a model group."""
    if model_size() == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(model_size())]
    _dist().all_gather(out, t, group=model_group())
    return out


# ---- launching a host's ranks -----------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, local: int, n_local: int, n_model: int,
               coordinator: str, device: str, backend: Optional[str],
               results) -> None:
    """One rank: joins the world, runs ``fn(*args)`` and sends back (local
    index, ok, pickled result or traceback)."""
    os.environ[LOCAL_RANK_FLAG] = str(local)
    os.environ[LOCAL_WORLD_FLAG] = str(n_local)
    os.environ[MODEL_RANKS_FLAG] = str(n_model)
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
        destroy()


def launch(fn: Callable[..., Any], args: Sequence[Any], n_local: int,
           device: str = "cuda", backend: Optional[str] = None,
           n_model: int = 1) -> List[Any]:
    """Runs ``fn(*args)`` on ``n_local`` ranks of this host, each a process
    of its own (the ``spawn`` start method; ``fn`` a module-level
    function) that has joined the world (:func:`maybe_initialize` with
    ``device`` and ``backend``) on a grid with a model axis of
    ``n_model``, and returns their results in local order.
    Results cross the process boundary pickled.  A rank that raises or dies
    stops the others and makes this raise, with its traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    coordinator = os.environ.get(COORDINATOR_FLAG, "").strip() or \
        f"127.0.0.1:{free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, tuple(args), i, n_local, n_model, coordinator, device, backend,
        results),
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
