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
"""

import numpy as np
import torch

from ..constants import R, fr_root_of_unity
from ..ops import limbs as lb
from ..ops.field_ops import FR
from ..ops.ntt import ntt_device
from .mesh import to_device

_steps = {}


def _twiddle_rows(n: int, d: int, inverse: bool) -> np.ndarray:
    """[d, 16, n2] Montgomery plane: row j1, column k2 -> w^(j1 k2)."""
    n2 = n // d
    w = fr_root_of_unity(n)
    if inverse:
        w = pow(w, R - 2, R)
    rows = []
    for j1 in range(d):
        wj = pow(w, j1, R)
        vals, acc = [], 1
        for _ in range(n2):
            vals.append(acc)
            acc = acc * wj % R
        rows.append(FR.to_mont_host(vals))
    return np.stack(rows)


def make_ntt_step(mesh, axis: str, n: int, inverse: bool = False):
    """The (cached) step [16, n] Montgomery on any device -> [16, n] on the
    mesh's lead device. n must be divisible by D^2, D the axis size."""
    key = (mesh, axis, n, inverse)
    if key in _steps:
        return _steps[key]
    devices = mesh.axis_devices(axis)
    d = len(devices)
    n2 = n // d
    if n2 * d != n or n2 % d:
        raise ValueError(f"n ({n}) must be divisible by D^2 ({d * d})")
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


def sharded_ntt(mesh, axis: str, x_mont: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural-order multi-device NTT of [16, n] Montgomery limbs."""
    return make_ntt_step(mesh, axis, x_mont.shape[-1], inverse)(x_mont)


def sharded_ntt_ints(mesh, axis: str, values, inverse: bool = False) -> list:
    """Python ints -> Python ints, through `sharded_ntt` from the lead device."""
    x = lb.as_limb_tensor(FR.to_mont_host([v % R for v in values]), mesh.lead)
    return FR.from_mont_host(sharded_ntt(mesh, axis, x, inverse=inverse))
