"""Several processes, on one host or many, over `torch.distributed` (the
JAX package's `parallel/distributed.py`).

JAX runs multi-controller: `jax.distributed` joins every process's chips
into one global device list and the same `shard_map` programs run on it.
The port runs SPMD: every process calls the same entry points in the same
order, drives its own local devices as the single-process mesh does
(`parallel/mesh.py`), and exchanges only small results. A mesh from
`global_mesh` holds the rank that owns each cell; on it,
`parallel.msm` runs this process's cells only and folds each row's
partials on `dispatch.fold` (one g1_fold launch on a card), then makes
one all_gather per call of its int32 Jacobian partials
(`all_gather_points`), which every process folds in rank order:
- the fixed-base MSM (`ShardedBasis`, tables for this process's cells
  only): a [3, 12, B] point a batch;
- the generic MSM (JAX's `_local_window_sums` steps): the window sums
  [3, 12, B W], infinity at the rows and windows of other processes,
  then one Horner combine (`dispatch.combine_windows`).
Every process returns the same points, the whole batch. The Fr layer,
decompression and the pairing check run in every process on its own
lead device.

Usage (one call per process, before building meshes):

    from lambdaworks_kzg_tpu_torch.parallel import distributed
    distributed.initialize()          # from the environment, or a no-op
    mesh = distributed.global_mesh()  # (data, points) over every process
    ctx = EIP4844Context(setup, mesh=mesh)

Layout rule, JAX's: ``points`` spans one process's devices, ``data``
spans processes, so the gather carries whole blobs' partials; explicit
sizes override (``data=1, points=W`` splits one MSM over W processes).
"""

import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import limbs as lb
from .mesh import Mesh, _device, make_mesh

_local_devices = None  # this process's devices, chosen by `initialize`


def _is_local(host: str) -> bool:
    return host in ("localhost", "127.0.0.1", "::1", socket.gethostname())


def _plan(host: str, world: int, rank: int):
    """(backend, local devices): one process per card where each local
    rank can have its own (nccl), else gloo, the local ranks sharing the
    cards round robin, or the CPU. The local ranks are LOCAL_WORLD_SIZE /
    LOCAL_RANK (torchrun's), else every rank when the coordinator is this
    host, else this one."""
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE") or (world if _is_local(host) else 1))
    local_rank = int(os.environ.get("LOCAL_RANK") or rank % local_ranks)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= local_ranks and cards:
        per = cards // local_ranks
        return "nccl", [torch.device("cuda", local_rank * per + i) for i in range(per)]
    if cards:
        return "gloo", [torch.device("cuda", local_rank % cards)]
    return "gloo", [torch.device("cpu")]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join the process group. Explicit arguments win; otherwise
    COORDINATOR_ADDRESS ("host:port", JAX's), or torchrun's MASTER_ADDR
    and MASTER_PORT, with WORLD_SIZE and RANK. With no coordinator it is
    a no-op that returns False: one process needs no group. Idempotent.
    backend: "nccl" or "gloo"; by default nccl when each local rank has a
    card of its own, gloo otherwise (ranks sharing a card, the CPU)."""
    global _local_devices
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if env.get("COORDINATOR_ADDRESS"):
            coordinator_address = env["COORDINATOR_ADDRESS"]
        elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            return False
    try:
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise ValueError(f"a coordinator needs the process count and id (or {e.args[0]})") from e
    host = coordinator_address.rsplit(":", 1)[0].strip("[]")
    chosen, devices = _plan(host, world, rank)
    backend = backend or chosen
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    _local_devices = devices
    return True


def is_initialized() -> bool:
    return dist.is_initialized()


def global_mesh(data: Optional[int] = None, points: Optional[int] = None,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """A (data, points) mesh over the devices of every process, each
    process bringing `local_devices` (default: those `initialize` chose).
    The cells are laid out rank by rank, a process's devices in a row:
    by default ``points`` spans one process's devices and ``data`` the
    processes. The mesh uses every device of every process. Without a
    process group it is `make_mesh` over the local devices."""
    local = [_device(d) for d in (local_devices if local_devices is not None
                                  else _local_devices or [_default_device()])]
    if not dist.is_initialized():
        return make_mesh(local, data, points)
    world, rank = dist.get_world_size(), dist.get_rank()
    everyone = [None] * world
    dist.all_gather_object(everyone, [str(d) for d in local])
    per = len(local)
    if any(len(devs) != per for devs in everyone):
        raise ValueError(f"every process must bring as many devices: {[len(d) for d in everyone]}")
    total = per * world
    if data is None and points is None:
        data, points = (world, per) if world > 1 else tuple(make_mesh(local).shape.values())
    elif data is None:
        data = total // points if points and total % points == 0 else 0
    elif points is None:
        points = total // data if data and total % data == 0 else 0
    if data < 1 or points < 1 or data * points != total:
        raise ValueError(f"a mesh across {world} processes of {per} devices must use all "
                         f"{total}: got {data}x{points}")
    cells = [(g // per, torch.device(everyone[g // per][g % per])) for g in range(total)]
    return Mesh(tuple(tuple(dev for _, dev in cells[r * points:(r + 1) * points]) for r in range(data)),
                ranks=tuple(tuple(owner for owner, _ in cells[r * points:(r + 1) * points])
                            for r in range(data)),
                rank=rank)


def _default_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def all_gather_points(points16: torch.Tensor) -> torch.Tensor:
    """This process's Jacobian points [3, L, B] (public layout) -> every
    process's, [W, 3, L, B] in rank order on points16's device: one
    all_gather of the [3, 12, B] int32 kernel layout (through host
    tensors on gloo)."""
    k32 = lb.to_u32_layout(points16)
    if dist.get_backend() != "nccl":
        k32 = k32.cpu()
    out = [torch.empty_like(k32) for _ in range(dist.get_world_size())]
    dist.all_gather(out, k32)
    return torch.stack([lb.to_u16_layout(t.to(points16.device)) for t in out])
