"""Multi-process training on torch.distributed (port of
clair_tpu/parallel/distributed.py).

The JAX package runs one controller per host, and jax.distributed joins
the hosts into one global device set. The port takes torch's idiom: one
process per device, joined by ``init_process_group`` (NCCL on CUDA, gloo on
the CPU). One host's devices are spawned from one command
(``spawn``; the train command's --num_devices); across hosts every process
runs the train command with the coordinator's address, the process count
and its own rank.

The design invariants of the JAX package carry over, and make a
multi-process run the single-process run:

- Every process iterates the SAME epoch stream (same bin, same seed, the
  same block shuffle), pads each global batch to a multiple of the data
  axis with sample weight 0, and takes its data row's stripe of it
  (``local_stripe``), so the global batch is the single-process one.
- The gradients are summed over each data group inside ``backward()``
  (parallel/sharding.py), so the parameters never diverge. Dropout masks
  differ by data row (a generator seeded seed + data index), as they must
  for the stripes not to share masks, and are the same along a model
  row, whose ranks compute the replicated layers together.
- Every schedule decision is taken on all-reduced losses, so all processes
  agree on it; only process 0 writes checkpoints, and resume loads there
  and broadcasts (``broadcast_checkpoint``), so no shared filesystem is
  needed.

The JAX package's ``make_global_array`` has no counterpart: every process
holds its own stripe as a plain tensor. Its ``host_replicated`` is
parallel/tensor_parallel.py's ``gather_params`` where a model axis splits
the parameters; without one every process holds them whole.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the collectives' timeout (init and every collective after it)
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device_type: str = "cuda",
    *,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the process group at ``coordinator_address`` (host:port of
    process 0) as rank ``process_id`` of ``num_processes``; returns this
    process's device.

    On CUDA the device is ``cuda:<process_id mod the visible count>`` unless
    ``device`` names one, and becomes the current device before the group
    is made. The backend is NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one (gloo also all-reduces CUDA tensors, and takes
    two processes on one card, which NCCL refuses). Ends with one
    all-reduce over every process."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed on 'cuda' needs a CUDA device and "
                               "torch.cuda.is_available() is false")
        rank_device = torch.device(device or f"cuda:{process_id % torch.cuda.device_count()}")
        torch.cuda.set_device(rank_device)
    elif device_type == "cpu":
        rank_device = torch.device("cpu")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    dist.init_process_group(
        backend or ("nccl" if device_type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _collective_barrier(rank_device)
    return rank_device


def _collective_barrier(device: torch.device) -> None:
    """One all-reduce over every process NOW, while all of them are at the
    same point: a process that cannot reach the others fails here, within
    the timeout, and not inside the first train step."""
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones)
    if int(ones.item()) != dist.get_world_size():
        raise RuntimeError(f"the barrier summed {ones.item()} over {dist.get_world_size()} "
                           "processes")


def process_info() -> tuple:
    """(rank, world size); (0, 1) when no process group is initialised."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def check_multihost_mesh(mesh, num_processes: int) -> None:
    """Fail loud on a mesh the striped batch cannot serve: the mesh must
    hold each of the ``num_processes`` ranks once (one device per rank), the
    data rows must ascend by rank (so each row's stripe is the one
    local_stripe hands it), and a model axis must not cross hosts (every
    process all-gathers the host names, where the model axis is wider than
    1: a collective, so every process raises alike)."""
    grid = mesh.mesh
    names = list(mesh.mesh_dim_names or ())
    if "data" in names:
        grid = grid.movedim(names.index("data"), 0)
    ranks = grid.flatten().tolist()
    if sorted(ranks) != list(range(num_processes)):
        raise ValueError(
            f"the mesh must hold each of the {num_processes} processes once (one device per "
            f"rank); it holds ranks {ranks}")
    rows = grid.reshape(grid.shape[0], -1)
    along_data = rows[:, 0].tolist()
    if along_data != sorted(along_data):
        raise ValueError(f"mesh data-rows must ascend by rank, got {along_data}")
    if rows.shape[1] > 1:
        hosts = [None] * num_processes
        dist.all_gather_object(hosts, socket.gethostname())
        for row in rows.tolist():
            if len({hosts[r] for r in row}) != 1:
                raise ValueError(f"model_parallel must not cross hosts: a data-row of the mesh "
                                 f"spans hosts {sorted({hosts[r] for r in row})}")


def local_stripe(n_rows: int, data_index: int, data_size: int) -> slice:
    """The contiguous row stripe of a global batch owned by data row
    ``data_index`` of ``data_size`` (every rank of a model row takes the
    same). n_rows must divide by data_size (callers pad to the data-axis
    multiple)."""
    assert n_rows % data_size == 0, (n_rows, data_size)
    per = n_rows // data_size
    return slice(data_index * per, (data_index + 1) * per)


def broadcast_checkpoint(init_checkpoint: str) -> tuple:
    """Multi-process resume: process 0 loads the checkpoint and broadcasts
    (params, epoch) to every process, the full arrays (a rank holding a
    model shard cuts its own: parallel/tensor_parallel.py, shard_params). The others never open the file (their
    ``init_checkpoint`` is ignored), so no shared filesystem is needed and
    the epoch counter cannot differ. A load failure on process 0 is
    broadcast as a flag, so that every process raises instead of the others
    waiting in the collective."""
    from clair_tpu_torch.models.checkpoint import epoch_from_path, load_checkpoint

    bundle = [None, 0, True, ""]
    if dist.get_rank() == 0:
        try:
            params, _ = load_checkpoint(init_checkpoint)
            bundle = [params, epoch_from_path(init_checkpoint), True, ""]
        except Exception as exc:  # raised on every process below
            bundle = [None, 0, False, f"{type(exc).__name__}: {exc}"]
    dist.broadcast_object_list(bundle, src=0)
    params, epoch, ok, error = bundle
    if not ok:
        raise RuntimeError(f"process 0 failed to load {init_checkpoint!r}: {error}")
    return params, epoch


def free_port() -> int:
    """A free TCP port on this host, for a coordinator on localhost."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout_s: Optional[float] = None) -> List:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes (start method
    spawn) and return their results, by rank. ``fn`` and its arguments and
    results are pickled: a module-level function and plain data. A process
    that raises makes this raise with its traceback (and ends the others);
    past ``timeout_s`` seconds every process is killed and TimeoutError
    raised."""
    with tempfile.TemporaryDirectory(prefix="clair_ranks_") as out:
        context = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, tuple(args), out), nprocs=nprocs, join=False,
            start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not context.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                for proc in context.processes:
                    proc.kill()
                for proc in context.processes:
                    proc.join()
                raise TimeoutError(f"{nprocs} processes of {fn.__name__} did not finish "
                                   f"within {timeout_s} s")
        results = []
        for rank in range(nprocs):
            with open(os.path.join(out, f"{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results


def _rank_main(rank: int, fn: Callable, args: tuple, out: str) -> None:
    result = fn(rank, *args)
    path = os.path.join(out, f"{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(path + ".tmp", path)
