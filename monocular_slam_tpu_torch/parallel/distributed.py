"""Multi-process initialization, the global mesh, slab placement and the one
collective helper of the distributed solvers (counterpart of
`monocular_slam_tpu/parallel/distributed.py`).

  initialize()   -> `torch.distributed.init_process_group` from explicit
                    arguments or MSLAM_COORDINATOR / MSLAM_NUM_PROCESSES /
                    MSLAM_PROCESS_ID; the backend follows the device: NCCL
                    for CUDA tensors, gloo for the CPU.
  global_mesh()  -> a (data, model) mesh over every rank, host-major.
  model_sharded() / replicated() / put_global() -> placement of a full
                    array that every rank holds: each rank takes its slab by
                    slicing (no scatter collective).
  all_reduce()   -> the counterpart of `jax.lax.psum` / `pmax` over the
                    "model" axis; every collective of the solvers goes
                    through it, so `record_collectives` can count them.

torch's process groups ship no cluster auto-detection: without explicit
arguments or the MSLAM_* variables `initialize` stays single-process.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from monocular_slam_tpu_torch.parallel.mesh import make_mesh, model_axis
from monocular_slam_tpu_torch.utils.device import resolve_device

_INITIALIZED = False
_RECORD: list | None = None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None, backend: str | None = None) -> bool:
    """Initialize the default process group for a multi-process run
    (idempotent). Resolution order: explicit arguments, then the MSLAM_*
    variables. `coordinator_address` is "host:port" (a TCP rendezvous on
    that host) or an init-method URL ("tcp://...", "file://..."). The
    backend defaults to NCCL for `device` "cuda" (the default) and gloo for
    the CPU; gloo also reduces CUDA tensors (through host memory). Returns True if a multi-process group
    is up, False for single-process operation."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        return dist.get_world_size() > 1

    coordinator_address = coordinator_address or os.environ.get("MSLAM_COORDINATOR")
    if num_processes is None and "MSLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MSLAM_NUM_PROCESSES"])
    if process_id is None and "MSLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MSLAM_PROCESS_ID"])

    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the number of "
                         f"processes and this process's id (got {coordinator_address!r}, "
                         f"{num_processes!r}, {process_id!r})")
    backend = backend or ("nccl" if resolve_device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    _INITIALIZED = True
    return dist.get_world_size() > 1


def global_mesh(data: int = 1, device=None) -> DeviceMesh:
    """(data, model) mesh over every rank of the world, host-major. torch's
    launchers number the ranks of one host contiguously, so rank order is
    host order: a model-axis slab stays on one host whenever the shard count
    divides into hosts, and only the Schur sums cross hosts."""
    return make_mesh(dist.get_world_size(), data, device)


class Placement(NamedTuple):
    """Where each rank's part of a full array lies: the slabs of `axis` over
    the "model" axis, or the whole array (`axis` None)."""

    mesh: DeviceMesh
    axis: int | None


def model_sharded(mesh: DeviceMesh) -> Placement:
    """Landmark slabs over "model": the leading axis, or axis 1 when the mesh
    has a data axis (the reference's PartitionSpec(None, "model") there)."""
    return Placement(mesh, 1 if mesh.size(0) > 1 else 0)


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, None)


def put_global(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's part of `x`. Every rank must hold the SAME full array
    (deterministic construction); each takes its slab by slicing."""
    if placement.axis is None:
        return x
    _, shard, n = model_axis(placement.mesh)
    size = x.shape[placement.axis] // n
    return x.narrow(placement.axis, shard * size, size)


@contextlib.contextmanager
def record_collectives():
    """Every `all_reduce` issued inside the block, as dicts of op, element
    count, bytes and label, in issue order."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def all_reduce(group, *tensors: torch.Tensor, op: str = "sum", label: str = "solve"):
    """Sum (op "sum") or maximum (op "max") of each tensor over `group`, as
    ONE collective: the tensors (of one dtype) are flattened, concatenated,
    reduced in place and split back. Returns a tuple, or the one tensor.
    `label` tags the record ("gather" for a result's final exchange)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if _RECORD is not None:
        _RECORD.append({"op": op, "elements": flat.numel(),
                        "bytes": flat.numel() * flat.element_size(), "label": label})
    dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
    out = tuple(part.reshape(t.shape) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors))
    return out if len(out) > 1 else out[0]
