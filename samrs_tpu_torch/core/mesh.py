"""Data-parallel process group of the port (mirrors samrs_tpu/core/mesh.py).

The JAX training loops run on a one-axis ``data`` mesh over every device
(``MeshSpec((-1,), ("data",))``): the global batch is the processes' local
batches concatenated in process order, XLA sums the gradients over it and
flax's BatchNorm takes its moments over it.  Here one process drives one
card, launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``), and the same
global batch is made explicit:

  * ``init_data_mesh`` joins (or reuses) the default process group and
    gives rank r the card ``cuda:{LOCAL_RANK}``.  The backend is NCCL when
    every rank of a host has a card of its own, gloo otherwise (on the CPU,
    or when the host's ranks outnumber its cards and share them); it is a
    fixed rule, printed by the run, never a fallback after a failure;
  * ``mesh_shape`` resolves as ``MeshSpec`` does: ``-1`` is every rank, and
    an explicit shape must multiply to the world size;
  * inside ``sharded(mesh)`` the layers read ``active()``: dropout and
    drop-path draw the global batch's masks and keep the rank's rows, and
    BatchNorm reduces its moments over every rank (``all_reduce_sum``, with
    a gradient);
  * ``reduce_grads`` sums the gradients over the ranks (the loss of a rank
    is already normalised by the global count, so the sum is the global
    batch's gradient).
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("samrs_tpu_torch.mesh")

GRAD_BUCKET = 1 << 24  # elements of one gradient all-reduce (64 MB of fp32)


@dataclass(frozen=True)
class DataMesh:
    """Rank `rank` of `world` data-parallel ranks, on `device`; `backend` is
    None for one process (no process group)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None


def resolve_mesh_shape(shape: Sequence[int], world: int) -> Tuple[int, ...]:
    """``MeshSpec.resolve`` over ranks: one ``-1`` takes the ranks the other
    axes leave; the product must equal the world size."""
    shape = [int(s) for s in shape]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if world % known:
            raise ValueError(f"{world} ranks not divisible by {known}")
        shape[shape.index(-1)] = world // known
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} != {world} ranks")
    return tuple(shape)


def backend_rule(device_type: str, local_world: int, cards: int) -> str:
    """NCCL when each of a host's ranks has a card of its own; gloo on the
    CPU or when ranks share a card (NCCL refuses two ranks on one card)."""
    if device_type == "cuda" and local_world <= cards:
        return "nccl"
    return "gloo"


def init_data_mesh(mesh_shape: Sequence[int] = (-1,), device: str = "cuda") -> DataMesh:
    """The data mesh of this process: the default process group if one is
    initialised, else one from torchrun's environment, else one process on
    `device`.  Raises if `mesh_shape` does not name the world size."""
    env = os.environ
    world = dist.get_world_size() if dist.is_initialized() else int(env.get("WORLD_SIZE", 1))
    resolve_mesh_shape(mesh_shape, world)
    dev = torch.device(device)
    if world == 1:
        return DataMesh(device=dev)
    rank = dist.get_rank() if dist.is_initialized() else int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device=cuda but no CUDA device is visible")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = backend_rule("cuda", local_world, cards)
    else:
        cards, backend = 0, "gloo"
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    logger.info("data mesh: rank %d of %d on %s, backend %s (%d ranks on this host, %d cards)",
                rank, world, dev, backend, local_world, cards)
    return DataMesh(rank, world, dev, backend)


# the mesh of the data-parallel step running now.  Process-wide, not a context variable:
# on the card the autograd engine runs a checkpointed block's recompute (the heads' dropout,
# remat's BatchNorms) on a thread of its own, which must see the step's mesh too
_active: Optional[DataMesh] = None


def active() -> Optional[DataMesh]:
    """The mesh of the training step running now, if it spans several ranks."""
    return _active


@contextlib.contextmanager
def sharded(mesh: Optional[DataMesh]) -> Iterator[None]:
    """Within this block the batch each layer sees is the rank's rows of the
    mesh's global batch (a no-op for one process)."""
    global _active
    if mesh is None or mesh.world == 1:
        yield
        return
    prev, _active = _active, mesh
    try:
        yield
    finally:
        _active = prev


def all_reduce_(t: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """Sum `t` over the ranks in place (nothing for one process)."""
    if mesh is not None and mesh.world > 1:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    the ranks' output gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """Differentiable sum of `t` over the ranks (`t` itself for one process)."""
    if mesh is None or mesh.world == 1:
        return t
    return _AllReduceSum.apply(t)


def _buckets(grads: Sequence[torch.Tensor]) -> Iterator[list]:
    bucket, size = [], 0
    for g in grads:
        if bucket and size + g.numel() > GRAD_BUCKET:
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def reduce_grads(params: Sequence[torch.Tensor], mesh: Optional[DataMesh]) -> None:
    """Sum the parameters' gradients over the ranks, in flat buckets of up to
    GRAD_BUCKET elements (every rank holds the same parameters in the same
    order, with a gradient on the same ones)."""
    if mesh is None or mesh.world == 1:
        return
    for bucket in _buckets([p.grad for p in params if p.grad is not None]):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        for g, v in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(v.view_as(g))


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank (nothing for one process)."""
    if mesh is None or mesh.world == 1:
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
