"""The multi-device NTT over Fr: the four-step transform on one mesh axis
(the JAX package's `parallel/ntt.py`).

For n = D n2 on the D devices of an axis, with j = j1 + D j2 and
k = k2 + n2 k1:

  X[k2 + n2 k1] = NTT_D over j1 [ w^(j1 k2) NTT_n2 over j2 [ x ] ]

  1. device j1 takes the strided row x[j1::D] and runs the inner NTT of
     size n2 (`ops/ntt.ntt_device`, no 1/n);
  2. it multiplies by its twiddle row w^(j1 k2);
  3. JAX's all_to_all: device j1' gets chunk j1' (n2/D columns) of every
     device's row, by one copy from each (`mesh.to_device`, ordered by
     events);
  4. each device runs the outer NTTs of size D over its columns, and the
     inverse scales by 1/n; the blocks are gathered on the lead device.

Natural order in and out ([16, n] Montgomery limbs, the semantics of
`host/fft.fr_fft`). These are PyTorch ops, as the JAX step is XLA.

On a mesh that spans processes (`distributed.global_mesh`, JAX's
multi-controller mesh) every process passes the same input and gets the
whole result on its lead device, as JAX's output is replicated. A
process builds twiddle rows for the cells of the axis that it owns and
runs steps 1, 2 and 4 for them only. Step 3 exchanges each process's
chunks in JAX's [16, D, n2/D] split (copies between two cells of one
process stay `to_device`): one `torch.distributed.batch_isend_irecv`
of a send and a receive per other process, on any backend (gloo has no
all_to_all in some torch builds). One `all_gather` of the blocks ends
it. On gloo both go through host tensors, as
`distributed.all_gather_points` does.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..constants import R, fr_root_of_unity
from ..ops import limbs as lb
from ..ops.field_ops import FR
from ..ops.ntt import ntt_device
from .mesh import to_device

_steps = {}


def _twiddle_rows(n: int, d: int, inverse: bool, rows=None) -> np.ndarray:
    """[len(rows), 16, n2] Montgomery plane (rows: by default all d): row
    j1, column k2 -> w^(j1 k2)."""
    n2 = n // d
    w = fr_root_of_unity(n)
    if inverse:
        w = pow(w, R - 2, R)
    out = []
    for j1 in range(d) if rows is None else rows:
        wj = pow(w, j1, R)
        vals, acc = [], 1
        for _ in range(n2):
            vals.append(acc)
            acc = acc * wj % R
        out.append(FR.to_mont_host(vals))
    return np.stack(out)


def make_ntt_step(mesh, axis: str, n: int, inverse: bool = False):
    """The (cached) step [16, n] Montgomery on any device -> [16, n] on the
    mesh's lead device. n must be divisible by D^2, D the axis size
    (ValueError). The axis runs through the mesh's first cell: ``points``
    is row 0, ``data`` column 0, and the other cells take no part. Across
    processes, name the axis that crosses them: ``data`` on the default
    `global_mesh`, ``points`` on `global_mesh(data=1)`."""
    key = (mesh, axis, n, inverse)
    if key in _steps:
        return _steps[key]
    devices = mesh.axis_devices(axis)
    d = len(devices)
    n2 = n // d
    if n2 * d != n or n2 % d:
        raise ValueError(f"n ({n}) must be divisible by D^2 ({d * d})")
    if mesh.ranks is not None:
        _steps[key] = _process_step(mesh, axis, n, inverse)
        return _steps[key]
    rows = _twiddle_rows(n, d, inverse)
    twiddles = [lb.as_limb_tensor(rows[j1], dev) for j1, dev in enumerate(devices)]
    n_inv = {dev: lb.as_limb_tensor(FR.to_mont_host([pow(n, R - 2, R)]), dev) for dev in devices}
    m = n2 // d  # columns of each chunk

    def step(x: torch.Tensor) -> torch.Tensor:
        # element j1 + D j2 sits at x.reshape(16, n2, D)[:, j2, j1]
        strided = x.reshape(16, n2, d)
        inner = []
        for j1, dev in enumerate(devices):
            mine = to_device(strided[..., j1], dev)
            inner.append(FR.mul(ntt_device(mine, inverse=inverse, scale=False), twiddles[j1]))
        blocks = []
        for jp, dev in enumerate(devices):
            # the all_to_all: [16, D (j1), m] holds chunk jp of every row
            exchanged = torch.stack([to_device(row[:, jp * m:(jp + 1) * m], dev) for row in inner], 1)
            outer = exchanged.permute(2, 0, 1)  # [m, 16, D]: the outer NTTs over j1
            if d > 1:
                outer = ntt_device(outer, inverse=inverse, scale=False)
            if inverse:
                outer = FR.mul(outer, n_inv[dev])
            # outer[c, :, k1] = X[k2 + n2 k1] with k2 = jp m + c
            blocks.append(to_device(outer.permute(1, 2, 0), mesh.lead))  # [16, D (k1), m]
        return torch.stack(blocks, 2).reshape(16, n)  # [16, D (k1), D (jp), m]

    _steps[key] = step
    return step


def _process_step(mesh, axis: str, n: int, inverse: bool):
    """`make_ntt_step` on a mesh whose cells belong to several processes.

    Every buffer that crosses processes has one shape in every process,
    padded to `slots`, the most cells of the axis that one process owns:
    a process that owns none sends zeros and still gets the result."""
    devices = mesh.axis_devices(axis)
    owners = mesh.ranks[0] if axis == "points" else tuple(row[0] for row in mesh.ranks)
    d = len(devices)
    n2 = n // d
    m = n2 // d  # columns of each chunk
    rank, world = mesh.rank, dist.get_world_size()
    cells = [[j for j in range(d) if owners[j] == r] for r in range(world)]
    slot = {j: cells[owners[j]].index(j) for j in range(d)}  # its place among its owner's cells
    mine = cells[rank]
    remote = [j for j in range(d) if owners[j] != rank]
    slots = max(len(c) for c in cells)
    twiddles = {j: lb.as_limb_tensor(row, devices[j])
                for j, row in zip(mine, _twiddle_rows(n, d, inverse, mine) if mine else ())}
    n_inv = {devices[j]: lb.as_limb_tensor(FR.to_mont_host([pow(n, R - 2, R)]), devices[j]) for j in mine}
    stage = mesh.lead if dist.get_backend() == "nccl" else torch.device("cpu")

    def step(x: torch.Tensor) -> torch.Tensor:
        strided = x.reshape(16, n2, d)
        inner, chunks = {}, torch.zeros((slots, d, 16, m), dtype=torch.int64, device=stage)
        for j in mine:
            row = ntt_device(to_device(strided[..., j], devices[j]), inverse=inverse, scale=False)
            inner[j] = FR.mul(row, twiddles[j])
            chunks[slot[j]] = inner[j].reshape(16, d, m).transpose(0, 1).to(stage)
        # the all_to_all: process r gets [slots, slots, 16, m], chunk jp of
        # my cell j's row at [slot[j], slot[jp]] for each of r's cells jp
        send = [torch.zeros((slots, slots, 16, m), dtype=torch.int64, device=stage)
                for _ in range(world)]
        for r in range(world):
            if r != rank and cells[r]:
                send[r][:, :len(cells[r])] = chunks[:, cells[r]]
        recv = [torch.empty_like(t) for t in send]
        _all_to_all(recv, send, rank)
        blocks = torch.zeros((slots, 16, d, m), dtype=torch.int64, device=stage)
        local = {}
        for jp in mine:
            dev = devices[jp]
            pieces = {}
            if remote:
                got = torch.stack([recv[owners[j]][slot[j], slot[jp]] for j in remote]).to(dev)
                pieces = dict(zip(remote, got))
            for j in mine:
                pieces[j] = to_device(inner[j][:, jp * m:(jp + 1) * m], dev)
            outer = torch.stack([pieces[j] for j in range(d)], 1).permute(2, 0, 1)  # [m, 16, D]
            if d > 1:
                outer = ntt_device(outer, inverse=inverse, scale=False)
            if inverse:
                outer = FR.mul(outer, n_inv[dev])
            local[jp] = outer.permute(1, 2, 0)  # [16, D (k1), m]: X[k2 + n2 k1], k2 = jp m + c
            blocks[slot[jp]] = local[jp].to(stage)
        gathered = [torch.empty_like(blocks) for _ in range(world)]
        dist.all_gather(gathered, blocks)
        parts = [to_device(local[jp], mesh.lead) if jp in local
                 else gathered[owners[jp]][slot[jp]].to(mesh.lead) for jp in range(d)]
        return torch.stack(parts, 2).reshape(16, n)  # [16, D (k1), D (jp), m]

    return step


def _all_to_all(recv: list, send: list, rank: int) -> None:
    """recv[r] = what process r sent this one: a send and a receive per
    other process in one `dist.batch_isend_irecv`."""
    recv[rank].copy_(send[rank])
    others = [r for r in range(len(send)) if r != rank]
    if others:
        ops = [dist.P2POp(dist.isend, send[r], r) for r in others] + \
              [dist.P2POp(dist.irecv, recv[r], r) for r in others]
        for request in dist.batch_isend_irecv(ops):
            request.wait()


def sharded_ntt(mesh, axis: str, x_mont: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural-order multi-device NTT of [16, n] Montgomery limbs."""
    return make_ntt_step(mesh, axis, x_mont.shape[-1], inverse)(x_mont)


def sharded_ntt_ints(mesh, axis: str, values, inverse: bool = False) -> list:
    """Python ints -> Python ints, through `sharded_ntt` from the lead device."""
    x = lb.as_limb_tensor(FR.to_mont_host([v % R for v in values]), mesh.lead)
    return FR.from_mont_host(sharded_ntt(mesh, axis, x, inverse=inverse))
