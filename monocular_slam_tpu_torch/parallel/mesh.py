"""The (data, model) device mesh of the distributed solvers (counterpart of
`monocular_slam_tpu/parallel/mesh.py`).

The reference lays a `jax.sharding.Mesh` over the devices of one process
(or of several, after `jax.distributed.initialize`) with two axes:

  - "data":  embarrassing parallelism (replicas of a solve);
  - "model": landmark-slab sharding for bundle adjustment; the Schur
             reduction is a sum over this axis.

Here one rank of the initialized `torch.distributed` world is one shard:
a process drives one device, where JAX drives many devices from one
process. The mesh is a `torch.distributed.device_mesh.DeviceMesh` over
ranks 0..n_devices-1 laid out (data, model); a solve sums over the
process group of its "model" row. Every rank of the world must call
`make_mesh` (it creates process groups); a rank outside the mesh gets a
mesh on which it holds no coordinate.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from monocular_slam_tpu_torch.utils.device import resolve_device


def make_mesh(n_devices: int | None = None, data: int | None = None, device=None) -> DeviceMesh:
    """A (data, model) mesh over the first n_devices ranks of the world.

    `data` defaults to 1 (every rank on the model/landmark axis): global BA
    is the capacity-limited workload. `device` is the ranks' device (default:
    the card; pass `device="cpu"` for CPU ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.initialize or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    data = 1 if data is None else data
    if not (0 < n_devices <= world and n_devices % data == 0):
        raise ValueError(f"mesh of {n_devices} ranks as {data} x ? over a world of {world}")
    ranks = torch.arange(n_devices).reshape(data, n_devices // data)
    return DeviceMesh(resolve_device(device).type, ranks, mesh_dim_names=("data", "model"))


def model_axis(mesh: DeviceMesh):
    """(process group, shard index, shard count) of this rank's "model" row;
    raises on a rank outside the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return mesh.get_group("model"), mesh.get_local_rank("model"), mesh.size(1)
