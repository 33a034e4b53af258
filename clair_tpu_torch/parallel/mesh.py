"""The device mesh (port of clair_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over the devices one
controller sees. The port follows torch's idiom instead: one process per
device, joined by torch.distributed (parallel/distributed.py), and the mesh
is a DeviceMesh over those processes' ranks, laid out as the JAX grid: rank
r is data row r // m and model column r % m. The 'data' axis carries the
batch (DistributedDataParallel over its groups); the 'model' axis splits
the dense trunk (parallel/tensor_parallel.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'model') DeviceMesh of shape (n_devices // model_parallel,
    model_parallel) over the ranks of the initialised process group, one
    device per rank, rank r at (r // model_parallel, r % model_parallel).

    n_devices (default: the world size) must equal the world size: a mesh
    over fewer ranks than joined would leave some of them out of every
    collective, and one over more cannot be built. model_parallel must
    divide it (ValueError, as in the JAX package)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group, one process "
            "per device (parallel/distributed.py: init_distributed, or the train command's "
            "--num_devices)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    check_model_parallel(n, model_parallel)
    if n > world:
        raise ValueError(
            f"make_mesh needs {n} devices but only {world} are visible: {world} process(es) "
            f"joined the group, one device each. Start one process per device (--num_devices "
            f"on one host, --num_processes across hosts).")
    if n < world:
        raise ValueError(
            f"make_mesh over {n} devices while {world} processes joined: every process must "
            f"hold one device of the mesh (don't pass --num_devices smaller than the number "
            f"of processes)")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model_parallel, model_parallel),
                      mesh_dim_names=("data", "model"))


def check_model_parallel(n_devices: int, model_parallel: int) -> None:
    """Raise ValueError unless model_parallel is at least 1 and divides
    n_devices."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be at least 1, got {model_parallel}")
    if n_devices % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide n_devices={n_devices}")


def visible_devices(n: int, device_type: str = "cuda") -> list:
    """The devices ``cuda:0`` .. ``cuda:n-1`` (or n times "cpu"); raises
    when fewer than n CUDA devices are visible, rather than using fewer."""
    if device_type == "cpu":
        return ["cpu"] * n
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(
            f"--num_devices {n} needs {n} CUDA devices but only {visible} are visible "
            f"(torch.cuda.device_count())")
    return [f"cuda:{i}" for i in range(n)]
