"""Process groups for data and height parallelism, and the reductions the
training step and the spatial render need across them.

PyTorch counterpart of ``lsi_tpu/parallel/mesh.py`` (``MeshPlan``,
``make_mesh_plan``, ``assert_divisible``). JAX lays a (data x space) mesh
over devices and lets XLA emit the collectives; here every rank is one
process, and :class:`ProcessPlan` holds its rank, its device and the
process groups of a (data x space) grid: rank ``r`` sits at data index
``r // space`` and space index ``r % space``, and every group is created
on every rank in the same order, as ``torch.distributed.new_group``
requires.

The backend is chosen explicitly. ``nccl`` is the default when each rank
has a GPU of its own; ``gloo`` runs ranks on the CPU, or several ranks on
one GPU, which NCCL refuses (asking ``nccl`` for that raises, naming
``gloo``; nothing switches silently). Under ``gloo`` the point-to-point
transfers of CUDA tensors are staged through pinned host memory
(:func:`send_recv`), since gloo's send and receive read host memory only.

Data parallelism computes the GLOBAL batch's loss and gradient, as JAX's
sharded step does: the losses take their batch sums over
:attr:`ProcessPlan.batch_group` (``parallel.reduce``: all-reduced in the
forward, the identity in the backward), so each rank back-propagates its
own part of the global loss, and :func:`all_reduce_grads` sums those
parts into the global gradient.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from lsi_tpu_torch.device import resolve_device
from lsi_tpu_torch.parallel.reduce import all_reduce

DATA_AXIS = "data"
SPACE_AXIS = "space"
#: Seconds a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT_S = 1800


@dataclasses.dataclass(frozen=True)
class ProcessPlan:
    """One rank's place in the (data x space) grid.

    ``data_group``/``space_group`` are the process groups of the ranks
    that share this rank's space index / data index (None in a
    single-process plan); ``space_ranks`` are the global ranks of this
    rank's space group, in space order.
    """
    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    space: int = 1
    data_group: Any = None
    space_group: Any = None
    space_ranks: Tuple[int, ...] = (0,)

    @property
    def data(self) -> int:
        return self.world_size // self.space

    @property
    def data_rank(self) -> int:
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        return self.rank % self.space

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def batch_group(self):
        """The group the losses' batch sums reduce over: the data group,
        None with one rank on the data axis (no collective)."""
        return self.data_group if self.data > 1 else None


def make_process_plan(device="cuda", backend: Optional[str] = None,
                      space: int = 1, rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessPlan:
    """This process's plan, from explicit arguments or else from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; ``init_method`` defaults to ``env://``).

    Args:
      device: ``"cuda"`` (the rank's GPU: ``cuda:<LOCAL_RANK % count>``),
        an explicit ``cuda:i``, or ``"cpu"``.
      backend: ``"nccl"`` or ``"gloo"``; None takes ``nccl`` on the card
        and ``gloo`` on the CPU.
      space: the size of the space axis; the data axis is the rest.
    A single-process plan initialises no process group.
    """
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use nccl|gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo on "
                         "the CPU")
    if (backend == "nccl" and world_size > 1
            and local_world > torch.cuda.device_count()):
        raise ValueError(
            f"{local_world} ranks on this host share "
            f"{torch.cuda.device_count()} GPU(s), and NCCL refuses two "
            "ranks on one device: pass backend='gloo' (--dist_backend gloo)")
    if space < 1 or world_size % space:
        raise ValueError(f"world size {world_size} is not a multiple of the "
                         f"space axis {space}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size == 1:
        return ProcessPlan(device=dev, backend=backend)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    data = world_size // space
    space_groups = [dist.new_group([d * space + s for s in range(space)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * space + s for d in range(data)])
                   for s in range(space)]
    plan = ProcessPlan(
        rank=rank, world_size=world_size, device=dev, backend=backend,
        space=space, data_group=data_groups[rank % space],
        space_group=space_groups[rank // space],
        space_ranks=tuple((rank // space) * space + s for s in range(space)))
    if plan.is_main:
        print(f"[plan] {world_size} ranks ({DATA_AXIS} {data} x "
              f"{SPACE_AXIS} {space}), backend {backend}, rank 0 on {dev}",
              flush=True)
    return plan


def destroy(plan: ProcessPlan) -> None:
    """Tear down the process group a multi-process plan made."""
    if plan.world_size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def assert_divisible(global_batch: int, plan: ProcessPlan) -> None:
    if global_batch % plan.data != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by the data axis "
            f"{plan.data}")


def batch_slice(global_batch: int, plan: ProcessPlan) -> slice:
    """This rank's examples of a global batch (its data index's share)."""
    assert_divisible(global_batch, plan)
    per = global_batch // plan.data
    return slice(plan.data_rank * per, (plan.data_rank + 1) * per)


# ----------------------------------------------------------- collectives

def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def all_reduce_grads(plan: Optional[ProcessPlan],
                     grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the data group, in one collective."""
    if plan is None or plan.data == 1:
        return grads
    flat = all_reduce(_flat(grads.values()), plan.data_group)
    parts = flat.split([g.numel() for g in grads.values()])
    return {k: p.view_as(g) for (k, g), p in zip(grads.items(), parts)}


def broadcast_params(plan: Optional[ProcessPlan],
                     net: torch.nn.Module) -> None:
    """Every rank's parameters set to rank 0's, in one collective."""
    if plan is None or plan.world_size == 1:
        return
    params = list(net.parameters())
    with torch.no_grad():
        flat = _flat(p.detach() for p in params)
        dist.broadcast(flat, src=0)
        for p, v in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(v.view_as(p))


def send_recv(plan: ProcessPlan, sends, recvs) -> None:
    """Point-to-point transfers within the space group, all posted before
    any is waited on (so no order of the ranks deadlocks): ``sends`` and
    ``recvs`` are lists of (space index, tensor); received tensors are
    filled in place. Under gloo, CUDA tensors go through pinned host
    buffers."""
    stage = plan.backend == "gloo"

    def host(t):
        return (torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if stage and t.is_cuda else t)

    out = []
    for _, t in sends:
        buf = host(t)
        if buf is not t:
            buf.copy_(t)  # synchronous: the strip is on the host after it
        out.append(buf)
    inb = [host(t) for _, t in recvs]
    reqs = ([dist.isend(b, plan.space_ranks[s], group=plan.space_group)
             for (s, _), b in zip(sends, out)]
            + [dist.irecv(b, plan.space_ranks[s], group=plan.space_group)
               for (s, _), b in zip(recvs, inb)])
    for r in reqs:
        r.wait()
    for (_, t), b in zip(recvs, inb):
        if b is not t:
            t.copy_(b)
