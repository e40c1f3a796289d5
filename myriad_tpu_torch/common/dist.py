"""Process plumbing for data parallelism across ranks (counterpart of
``myriad_tpu/common/dist.py``).

The JAX package trains one program over a global batch: each process feeds
its rows into the ``data`` axis of a device mesh and XLA reduces the
gradient.  The port runs one process a card, launched by ``torchrun``:

    torchrun --nproc_per_node N -m myriad_tpu_torch.train --cfg-path ...

Rank, world and local rank come from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), as the JAX
package takes them from ``jax.process_index()`` and ``jax.process_count()``.
``init_distributed_mode`` joins the process group when the launcher's
``WORLD_SIZE`` is above 1 and is a no-op otherwise; the run config's
``world_size`` decides nothing (the JAX package never reads it); its
``dist_url`` is the rendezvous (``env://``, the configs' and the default, or
a ``file://`` path).  With
``model_shards: 1``, ``use_mesh`` is the JAX package's data axis: data
parallel over the launched ranks, a world of one in a single process.
With ``model_shards: n`` > 1 the world must be a multiple of n: model groups
of n consecutive ranks hold the LLaMA's shards (``parallel.mesh.make_mesh``)
and the data groups across them split the batch.  ``make_mesh`` then sets
the data axis here (``set_data_axis``): the sums of ``all_sum_`` and
``all_sum_scalars``, the sampler's rank and the host seeds follow the data
rank (``get_data_rank``, ``get_data_world_size``), so that every rank of a
model group sees the same batch and each model group is counted once.

The transport is fixed before the group is built: gloo for CPU ranks; NCCL
when every rank of the host has a card of its own; gloo on CUDA tensors when
the ranks outnumber the host's cards (NCCL refuses two ranks on one device).
Rank r runs on ``cuda:(LOCAL_RANK % cards)``.  Nothing retries another
transport after a failure.
"""

from __future__ import annotations

import atexit
import datetime
import functools
import logging
import os
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as tdist

# the data axis under a model axis (``parallel.mesh.make_mesh`` sets it):
# (data rank, data size, the data group or None, model rank); None: every
# rank is a data rank of its own.  It belongs to the process, as the process
# group it describes does: the metric sums, the sampler and ``save_result``
# read it without a mesh at hand
_data_axis: Optional[Tuple[int, int, object, int]] = None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def launched_world() -> int:
    """The launcher's ``WORLD_SIZE`` (1 without a launcher)."""
    return _env_int("WORLD_SIZE", 1)


def transport(device_type: str, local_world: int, cards: int) -> str:
    """The backend for ``local_world`` ranks on one host with ``cards`` cards:
    gloo for CPU ranks, NCCL when each rank has a card of its own, else gloo
    on CUDA tensors."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if cards >= local_world else "gloo"


def model_shards(run_cfg) -> int:
    """The model axis a run config asks for: ``model_shards`` when
    ``use_mesh`` (true by default above 1), else 1, as the JAX runner
    reads them."""
    run_cfg = run_cfg or {}
    shards = int(run_cfg.get("model_shards", 1) or 1)
    return shards if bool(run_cfg.get("use_mesh", shards > 1)) else 1


def init_distributed_mode(run_cfg=None, device_type: str = "cuda") -> Optional[str]:
    """Join the launcher's process group when its ``WORLD_SIZE`` is above 1
    (``device_type`` the run's: ``cuda`` or ``cpu``); returns the backend
    joined, None in a world of one.  ``model_shards`` n > 1 needs a world
    that is a multiple of n and raises otherwise, a world of one included
    (the JAX ``make_mesh``'s error): nothing falls back to fewer shards."""
    run_cfg = run_cfg or {}
    shards = model_shards(run_cfg)
    world = get_world_size() if is_dist_avail_and_initialized() else launched_world()
    if shards < 1 or world % shards:
        raise ValueError(f"{world} ranks not divisible by model axis {shards} "
                         f"(run.model_shards={shards})")
    if is_dist_avail_and_initialized():
        return tdist.get_backend()
    if launched_world() <= 1:
        return None
    return join(device_type, str(run_cfg.get("dist_url") or "env://"))


def join(device_type: str = "cuda", init_method: str = "env://",
         timeout: Optional[datetime.timedelta] = None) -> str:
    """Join the launcher's process group (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the rendezvous
    ``init_method``) with ``transport``'s backend, this rank's card set
    current; ``timeout`` bounds every collective of the group.  Returns the
    backend."""
    world = launched_world()
    rank = _env_int("RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = transport(device_type, local_world, cards)
    if device_type == "cuda":
        torch.cuda.set_device(get_local_rank() % cards)
    logging.info("joining the process group: rank %d of %d, backend %s (%d ranks on this "
                 "host, %d cards)", rank, world, backend, local_world, cards)
    kw = {} if timeout is None else {"timeout": timeout}
    tdist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                             **kw)
    atexit.register(destroy)
    return backend


def destroy() -> None:
    """Leave the process group (at exit)."""
    clear_data_axis()
    if is_dist_avail_and_initialized():
        tdist.destroy_process_group()


def device_of(name: str = "cuda") -> torch.device:
    """This rank's device for a run on ``name``: ``cuda:(LOCAL_RANK % cards)``
    under a launcher, ``cuda`` alone otherwise; the CPU as it is."""
    device = torch.device(name)
    if device.type != "cuda" or device.index is not None or launched_world() <= 1:
        return device
    return torch.device("cuda", get_local_rank() % max(torch.cuda.device_count(), 1))


def is_dist_avail_and_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_rank() -> int:
    return tdist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func):
    """Run ``func`` on rank 0 only (None elsewhere)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def _collective_device() -> torch.device:
    """Where a collective's scalars live: the card under NCCL, else the CPU."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def set_data_axis(rank: int, size: int, group, model_rank: int) -> None:
    """This rank's place on the data axis of a (data, model) mesh: its data
    rank of ``size``, the ``group`` of its data peers (None for a data axis
    of one) and its ``model_rank``; the data sums and ranks below follow it."""
    global _data_axis
    _data_axis = (int(rank), int(size), group, int(model_rank))


def clear_data_axis() -> None:
    global _data_axis
    _data_axis = None


def get_data_rank() -> int:
    """The rank's index on the data axis (its rank without a model axis)."""
    return _data_axis[0] if _data_axis is not None else get_rank()


def get_data_world_size() -> int:
    """The number of data-parallel ranks (the world without a model axis)."""
    return _data_axis[1] if _data_axis is not None else get_world_size()


def is_data_writer() -> bool:
    """Whether this rank writes its data rank's results: every rank without a
    model axis, a model group's first rank under one."""
    return _data_axis is None or _data_axis[3] == 0


def _data_group():
    return _data_axis[2] if _data_axis is not None else None


def all_sum_scalars(*values: float) -> Tuple[float, ...]:
    """Python scalars summed over the data-parallel ranks, in fp64."""
    if get_data_world_size() <= 1:
        return values
    t = torch.tensor(values, dtype=torch.float64, device=_collective_device())
    tdist.all_reduce(t, group=_data_group())
    return tuple(t.cpu().tolist())


def all_sum_(tensors: Iterable[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum ``tensors`` in place over the data-parallel ranks (the world
    without a model axis; ``group`` another group), one collective a dtype
    and device (the tensors flattened into one buffer and copied back); a
    no-op outside a process group and over a data axis of one.  Every rank
    receives the same bits."""
    tensors = list(tensors)
    if not is_dist_avail_and_initialized():
        return tensors
    if group is None:
        if _data_axis is not None and _data_axis[1] <= 1:
            return tensors
        group = _data_group()
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group_tensors in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        tdist.all_reduce(flat, group=group)
        offset = 0
        for t in group_tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself in a world of one)."""
    if get_world_size() <= 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Wait for every rank (a no-op in a world of one)."""
    if get_world_size() > 1:
        tdist.barrier()
