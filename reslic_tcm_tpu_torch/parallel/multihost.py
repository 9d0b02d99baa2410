"""Multi-process bring-up and data feeding (port of
reslic_tcm_tpu/parallel/multihost.py).

JAX's ``initialize_distributed`` makes ``jax.devices()`` global and its
jitted step one SPMD program over every host. Here each rank is a process
of a ``torch.distributed`` process group: NCCL between cards, gloo on the
CPU. Each rank feeds its own contiguous rows of the global batch
(``distribute_batch``), and the collectives are explicit.

A "data group" below is what the caller passes as ``mesh``: a DeviceMesh
(its ``"data"`` dimension), a ProcessGroup, or None for the default group.
Without a process group every helper sees a world of one.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator: str, num_processes: int, process_id: int,
                           device="cuda") -> None:
    """Join the process group whose rank 0 listens at ``coordinator``
    ("host:port") as rank ``process_id`` of ``num_processes``. The backend
    follows ``device``: NCCL for ``cuda`` (the process takes card
    ``LOCAL_RANK``, else ``process_id`` modulo the cards, and the
    communicator is set up here), gloo for ``cpu``. A failed NCCL set-up
    raises; nothing falls back to gloo."""
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the process count and this process's id")
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL process group; pass device='cpu' "
                               "for gloo")
        index = int(os.environ.get("LOCAL_RANK", int(process_id) % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="tcp://" + coordinator, world_size=int(num_processes),
                            rank=int(process_id), **kwargs)


def ensure_world(n: int, device) -> None:
    """A process group of ``n`` ranks: the one already set up, the one
    ``torchrun`` describes in the environment, or for ``n == 1`` a world of
    one on a free localhost port. Raises on any other world size."""
    if not dist.is_initialized():
        env = os.environ
        if "WORLD_SIZE" in env and "MASTER_ADDR" in env:
            initialize_distributed(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                                   int(env["WORLD_SIZE"]), int(env["RANK"]), device)
        elif n == 1:
            initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device)
        else:
            raise ValueError(f"{n} ranks need a process group: start one process per rank "
                             f"(torchrun --nproc-per-node {n} ...)")
    if dist.get_world_size() != n:
        raise ValueError(f"asked for {n} ranks, the process group has "
                         f"{dist.get_world_size()}")


def data_group(mesh=None):
    """The process group of ``mesh`` (see the module docstring)."""
    if mesh is None or isinstance(mesh, dist.ProcessGroup):
        return mesh
    return mesh.get_group("data")


def rank_and_size(mesh=None) -> tuple[int, int]:
    """(this rank, ranks) in the data group; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    group = data_group(mesh)
    return dist.get_rank(group), dist.get_world_size(group)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_size(global_batch: int, mesh=None) -> int:
    """Rows of a global batch that this rank feeds."""
    _, n = rank_and_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def distribute_batch(mesh, batch):
    """This rank's contiguous rows of the global ``batch`` (array or
    tensor), rank r taking rows [r*b, (r+1)*b)."""
    r, _ = rank_and_size(mesh)
    b = local_batch_size(len(batch), mesh)
    return batch[r * b:(r + 1) * b]


@torch.no_grad()
def broadcast_module(module, mesh=None) -> None:
    """Every parameter and buffer of ``module`` set, on every rank of the
    data group, to the group's first rank's values."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)


def replicated_to_host(x) -> np.ndarray:
    """A tensor every rank holds the same copy of, as a host array."""
    return x.detach().cpu().numpy()


def gather_cat(t: torch.Tensor, mesh=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank
    order, on every rank. An int16 tensor travels as int32 (NCCL has no
    16-bit integers)."""
    if t.dtype == torch.int16:
        return gather_cat(t.to(torch.int32), mesh, dim).to(torch.int16)
    group = data_group(mesh)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def gather_objects(items: list, mesh=None) -> list:
    """Every rank's list of picklable ``items``, concatenated in rank
    order, on every rank."""
    group = data_group(mesh)
    lists = [None] * dist.get_world_size(group)
    dist.all_gather_object(lists, items, group=group)
    return [item for part in lists for item in part]
