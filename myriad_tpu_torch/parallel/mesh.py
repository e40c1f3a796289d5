"""The ('data', 'model') mesh over the launcher's ranks (counterpart of
``myriad_tpu/parallel/mesh.py``).

The JAX package lays one ``jax.sharding.Mesh`` over its devices, the
``model`` axis innermost, and lets GSPMD place the collectives.  The port
runs one process a rank, started by ``torchrun``: ``make_mesh(n_model)``
splits the joined process group into model groups of ``n_model``
consecutive ranks (ranks ``[d*n, (d+1)*n)`` form model group d, the model
axis innermost) and data groups across them, and ``Mesh`` carries this
rank's place and the model group's collectives, which the sharded LLaMA
calls itself (``models/llama.py``).

    torchrun --nproc_per_node 2 serve.py      # serve.py: mesh = make_mesh(2); ...

A mesh of ``n_model=1`` has no process group and no collective: a model
built with it runs exactly the unsharded code.  The transport is
``common.dist``'s rule: NCCL when each rank has a card of its own, gloo on
CUDA tensors when ranks share a card (NCCL refuses two ranks on one
device), gloo on the CPU.  Every collective runs under the group's timeout
(``timeout``, given to ``init_process_group`` when ``make_mesh`` joins and
to every group it makes): a rank that stops answering fails the others'
next collective instead of hanging them.

Training goes through the collectives under autograd, Megatron's pair of
conjugate functions and the gather:

* ``copy_to_model``: the identity forward, the sum of the gradient over the
  model group backward; at the input of a column-parallel region, whose
  ranks each see a part of the input's gradient;
* ``reduce_from_model``: the sum over the model group forward, the identity
  backward; at the output of a row-parallel product;
* ``gather_from_model``: the pieces concatenated forward, this rank's slice
  of the gradient backward; the embedding's hidden columns and the
  vocabulary-split logits;
* ``broadcast_from_lead``: the group's first rank's tensor forward, its
  gradient kept on that rank backward (every rank holds the same, whole
  gradient there).

They count their collectives, forward and backward, in ``calls`` and
``times``.  ``torch.distributed.nn.functional.all_reduce`` is not one of
them: its backward sums the gradient again, which makes a gradient that
every rank of a group computes alike n times too large.  Without autograd
(serving, ``torch.inference_mode``) each is the plain collective.
``model_sum_``, ``data_sum_`` and ``world_sum_`` sum flat buffers over the
model group, the data group and every rank (the gradients of a training
step).
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Optional

import torch
import torch.distributed as tdist

from myriad_tpu_torch.common import dist


@dataclasses.dataclass
class Mesh:
    """This rank's place on a (data, model) mesh and the model group's
    collectives.

    ``n_model`` ranks hold one model's shards; ``model_rank`` is this rank's
    index among them (its shard), ``lead`` the global rank of the group's
    first rank.  ``n_data`` model groups serve side by side; ``data_rank``
    is this rank's group.  ``calls`` counts the collectives by kind and
    ``seconds`` their host time (each call's wall, the wait for the other
    ranks included); set both to 0 to measure a stretch of work."""

    n_model: int = 1
    model_rank: int = 0
    n_data: int = 1
    data_rank: int = 0
    lead: int = 0
    model_group: Optional[object] = None
    data_group: Optional[object] = None
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    calls: dict = dataclasses.field(default_factory=dict)
    times: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def sharded(self) -> bool:
        return self.n_model > 1

    def _count(self, kind: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.times[kind] = self.times.get(kind, 0.0) + dt
        self.seconds += dt

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the model group (``op`` "sum" or
        "max"); every rank receives the same bits."""
        t0 = time.perf_counter()
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX if op == "max" else tdist.ReduceOp.SUM,
                         group=self.model_group)
        self._count(f"all_reduce_{op}", t0)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model group's ``t`` (equal shapes) concatenated along ``dim``
        (the last by default) in rank order.  Over gloo, which gathers no
        CUDA tensor, each rank writes its piece into a zero buffer and the
        buffers are summed: one piece and zeros a position, so the sum is
        exact."""
        dim = dim % t.dim()
        if dim != t.dim() - 1:
            return self.all_gather(t.movedim(dim, -1)).movedim(-1, dim).contiguous()
        t0 = time.perf_counter()
        n, w = self.n_model, t.shape[-1]
        if self.backend == "nccl":
            out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            tdist.all_gather_into_tensor(out, t.contiguous(), group=self.model_group)
            out = out.movedim(0, -2).reshape(*t.shape[:-1], n * w)
        else:
            out = torch.zeros(*t.shape[:-1], n * w, dtype=t.dtype, device=t.device)
            out[..., self.model_rank * w:(self.model_rank + 1) * w] = t
            tdist.all_reduce(out, group=self.model_group)
        self._count("all_gather", t0)
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """The model group's first rank's ``t``, in place on every rank."""
        t0 = time.perf_counter()
        tdist.broadcast(t, src=self.lead, group=self.model_group)
        self._count("broadcast", t0)
        return t

    def broadcast_object(self, obj):
        """The model group's first rank's picklable ``obj`` on every rank."""
        t0 = time.perf_counter()
        box = [obj]
        tdist.broadcast_object_list(box, src=self.lead, group=self.model_group)
        self._count("broadcast_object", t0)
        return box[0]

    # -- under autograd (training) ---------------------------------------------
    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; backward, its gradient summed over the model group."""
        return _CopyToModel.apply(x, self) if _tracked(x) else x

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model group; backward, the gradient as it is."""
        return _ReduceFromModel.apply(x, self) if _tracked(x) else self.all_reduce_(x)

    def gather_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather`` along the last dim; backward, this rank's slice."""
        return _GatherFromModel.apply(x, self) if _tracked(x) else self.all_gather(x)

    def broadcast_from_lead(self, x: torch.Tensor) -> torch.Tensor:
        """The first rank's ``x`` (a copy); backward, the gradient on that rank
        only."""
        return _BroadcastFromLead.apply(x, self) if _tracked(x) else self.broadcast_(x.contiguous())

    def _sum_flat(self, tensors, group, kind: str) -> None:
        if group is None or not tensors:
            return
        t0 = time.perf_counter()
        dist.all_sum_(tensors, group=group)
        self._count(kind, t0)

    def model_sum_(self, tensors) -> None:
        """Sum ``tensors`` in place over the model group (flat buffers)."""
        self._sum_flat(list(tensors), self.model_group if self.sharded else None, "model_sum")

    def world_sum_(self, tensors) -> None:
        """Sum ``tensors`` in place over every rank of the mesh (flat buffers)."""
        self._sum_flat(list(tensors), tdist.group.WORLD if self.sharded else None, "world_sum")

    def data_sum_(self, tensors) -> None:
        """Sum ``tensors`` in place over the data group (flat buffers); a
        no-op over a data axis of one."""
        self._sum_flat(list(tensors), self.data_group if self.n_data > 1 else None,
                       "data_sum")

    def reset(self) -> None:
        self.calls, self.times, self.seconds = {}, {}, 0.0


def from_lead(mesh: Optional[Mesh], make, shape, dtype: torch.dtype,
              device) -> torch.Tensor:
    """``make()``, run once a model group: without a sharded ``mesh``, as it
    is; under one, on the group's first rank alone (its result cast to
    ``dtype`` and checked to be of ``shape``), while the other ranks
    allocate the buffer, which ``broadcast_from_lead`` fills on every rank.
    The towers' image tokens take this road in serving and training."""
    if mesh is None or not mesh.sharded:
        return make()
    if mesh.model_rank == 0:
        x = make().to(dtype)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"the lead's tensor is {tuple(x.shape)}, not {tuple(shape)}")
    else:
        x = torch.empty(shape, dtype=dtype, device=device)
    return mesh.broadcast_from_lead(x)


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        # a copy: autograd may hand the same gradient tensor to other branches
        t0 = time.perf_counter()
        dx = dy.contiguous().clone()
        tdist.all_reduce(dx, group=ctx.mesh.model_group)
        ctx.mesh._count("all_reduce_sum_grad", t0)
        return dx, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.all_gather(x)

    @staticmethod
    def backward(ctx, dy):
        r, w = ctx.mesh.model_rank, ctx.width
        return dy[..., r * w:(r + 1) * w].contiguous(), None


class _BroadcastFromLead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.lead = mesh.model_rank == 0
        return mesh.broadcast_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return (dy if ctx.lead else None), None


def make_mesh(n_model: Optional[int] = None, *, device: str = "cuda",
              timeout: Optional[datetime.timedelta] = None,
              init_method: str = "env://") -> Mesh:
    """Build this rank's ('data', 'model') mesh over the launcher's ranks.

    ``n_model`` defaults to 1 (a mesh with no process group).  Above 1 the
    launcher's group is joined first when it is not (``common.dist.join``:
    its environment, the rendezvous ``init_method``, ``device``'s
    transport, ``timeout``); the world must be a multiple of ``n_model``.
    Every rank calls this in the same order: each group is made by every
    rank of the world.  Above 1 it also sets ``common.dist``'s data axis
    (the data-parallel sums, sampler and seeds follow the data rank)."""
    n_model = int(n_model or 1)
    if n_model < 1:
        raise ValueError(f"model axis {n_model}")
    if n_model == 1:
        return Mesh(device=dist.device_of(device) if dist.launched_world() > 1
                    else torch.device(device))
    if not dist.is_dist_avail_and_initialized():
        dist.join(device, init_method, timeout=timeout)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_model != 0:
        raise ValueError(f"{world} ranks not divisible by model axis {n_model}")
    n_data = world // n_model
    kw = {} if timeout is None else {"timeout": timeout}
    model_group = data_group = tdist.group.WORLD
    if n_data > 1:
        for d in range(n_data):  # every rank makes every group, in one order
            g = tdist.new_group(list(range(d * n_model, (d + 1) * n_model)), **kw)
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):
            g = tdist.new_group(list(range(m, world, n_model)), **kw)
            if m == rank % n_model:
                data_group = g
    else:
        data_group = None
    dist.set_data_axis(rank // n_model, n_data, data_group, rank % n_model)
    return Mesh(n_model=n_model, model_rank=rank % n_model, n_data=n_data,
                data_rank=rank // n_model, lead=(rank // n_model) * n_model,
                model_group=model_group, data_group=data_group,
                backend=tdist.get_backend(), device=dist.device_of(device))
