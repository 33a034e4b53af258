"""The device mesh (port of clair_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over the devices one
controller sees. The port follows torch's idiom instead: one process per
device, joined by torch.distributed (parallel/distributed.py), and the mesh
is a DeviceMesh over those processes' ranks. The 'data' axis carries the
batch (DistributedDataParallel over its group); the 'model' axis is
always 1 here, since the model-axis split of the dense trunk is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the ROADMAP item that --model_parallel > 1 waits for, by title
MODEL_PARALLEL_ITEM = "'--model_parallel > 1'"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'model') DeviceMesh of shape (n_devices, 1) over the
    ranks of the initialised process group, one device per rank.

    n_devices (default: the world size) must equal the world size: a mesh
    over fewer ranks than joined would leave some of them out of every
    collective, and one over more cannot be built. model_parallel > 1
    raises NotImplementedError."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"--model_parallel {model_parallel}: the model-axis split of the dense trunk is "
            f"not ported (ROADMAP Queue 1, {MODEL_PARALLEL_ITEM})")
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be at least 1, got {model_parallel}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group, one process "
            "per device (parallel/distributed.py: init_distributed, or the train command's "
            "--num_devices)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
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
    return DeviceMesh(device_type, torch.arange(n).reshape(n, 1),
                      mesh_dim_names=("data", "model"))


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
