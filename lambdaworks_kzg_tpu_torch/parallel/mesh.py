"""The device mesh of the multi-device tier (the JAX package's
`parallel/mesh.py`).

Two axes, as in the JAX package:

  * ``data``   per-blob data parallelism: a batch of blobs is split
               over the rows;
  * ``points`` intra-MSM parallelism: the members of one MSM are split
               over the columns.

JAX's mesh is single-controller: one process drives every chip through
`shard_map`. Its counterpart here is one process that holds a grid of
`torch.device`s, queues each shard's work on that shard's device, copies
the small partial results between devices and folds them
(`parallel/msm.py`, `parallel/ntt.py`). One host needs no
`torch.distributed`.

Across processes (`parallel/distributed.py`, JAX's multi-controller
runs) the mesh also holds the rank that owns each cell and the rank of
the process that holds the mesh: every process calls the same entry
points in the same order, runs only its own cells and exchanges only
their small results. A mesh of one process has None there.

A device may repeat only where the caller lists it so: a mesh over
``["cuda:0"] * 4`` or ``["cpu"] * 8`` is a logical mesh, which runs every
shard on that one device; it checks the sharded results and counts the
sharded path's launches, and says nothing of scaling across devices.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..ops.dispatch import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A [data][points] grid of devices; hashable, so it can key a cache.

    ranks: None for a mesh of one process; across processes the
    [data][points] grid of the rank that owns each cell (whose device
    `devices` names as that process sees it), and rank: this process's."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: Optional[int] = None
    axis_names = ("data", "points")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "points": len(self.devices[0])}

    def owns(self, row: int, col: int) -> bool:
        """Whether this process runs cell (row, col)."""
        return self.ranks is None or self.ranks[row][col] == self.rank

    @property
    def lead(self) -> torch.device:
        """Where results are gathered, and where a backend on the mesh
        keeps its Fr layer and runs its pairing check: the first device,
        or across processes the first this process owns."""
        if self.ranks is None:
            return self.devices[0][0]
        return next(dev for r, row in enumerate(self.devices)
                    for p, dev in enumerate(row) if self.owns(r, p))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along `axis` through the lead device: row 0 for
        ``points``, column 0 for ``data``."""
        if axis == "points":
            return self.devices[0]
        if axis == "data":
            return tuple(row[0] for row in self.devices)
        raise ValueError(f"mesh axis must be 'data' or 'points', got {axis!r}")


def _device(d) -> torch.device:
    """A torch.device with its index: "cuda" names the current card, so
    that two names of one card compare equal."""
    d = resolve_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              points: Optional[int] = None) -> Mesh:
    """A (data, points) mesh over the given devices, by default every CUDA
    device of the machine (RuntimeError without CUDA; never the CPU).

    Axis sizes not given are chosen as the JAX package chooses them: with
    neither, data = 2 when the device count is even and above 1, else 1,
    and points takes the rest, since one MSM has far more parallel slack
    than a blob batch; with one, the other divides the device count. The
    mesh takes the first data * points devices; more than are given
    raises ValueError."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices (for instance "
                               "['cpu'] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if data is None and points is None:
        data = 2 if n % 2 == 0 and n > 1 else 1
        points = n // data
    elif data is None:
        if points < 1 or n % points:
            raise ValueError(f"the points axis ({points}) must divide the {n} devices")
        data = n // points
    elif points is None:
        if data < 1 or n % data:
            raise ValueError(f"the data axis ({data}) must divide the {n} devices")
        points = n // data
    if data < 1 or points < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{points}")
    if data * points > n:
        raise ValueError(f"a {data}x{points} mesh needs {data * points} devices, {n} given")
    return Mesh(tuple(tuple(devices[r * points:(r + 1) * points]) for r in range(data)))


def to_device(t: torch.Tensor, dest: torch.device) -> torch.Tensor:
    """t on dest (t itself when it is there already).

    Between two CUDA devices the order is made explicit with an event,
    not left to what `.to()` does across devices: the event is recorded
    on t's device's current stream, after the work queued there that
    writes t, and dest's current stream waits on it before the copy is
    queued from dest, so whatever dest's stream runs next reads t whole.
    Nothing waits on the host."""
    if t.device == dest:
        return t
    if t.is_cuda and dest.type == "cuda":
        written = torch.cuda.Event()
        written.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(dest).wait_event(written)
        with torch.cuda.device(dest):
            return t.to(dest, non_blocking=True)
    return t.to(dest)
