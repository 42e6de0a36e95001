"""Point-op routing: a CUDA tensor goes to its Hopper kernel
(`ops/kernels.py`), a CPU tensor to the plain version (`ops/g1_ops.py`).

The two sides hold points in different layouts: the kernels take
radix-2^32 int32 limbs, the plain versions radix-2^16 int64 limbs.
`to_op_layout` / `from_op_layout` convert between the public radix-2^16
layout and the one the ops of that device take; callers convert once
per table or bucket array, not once per op. `ops/g1_ops.py` offers the
same six names with the identity layout, so code written against this
module runs the plain versions on any device when handed `g1_ops`.
"""

import torch

from . import g1_ops, kernels, limbs as lb


def madd(p, q_aff, q_valid):
    if p.is_cuda:
        return kernels.madd(p, q_aff, q_valid)
    return g1_ops.madd(p, q_aff, q_valid)


def add(p, q):
    if p.is_cuda:
        return kernels.add(p, q)
    return g1_ops.add(p, q)


def dbl(p):
    if p.is_cuda:
        return kernels.dbl(p)
    return g1_ops.dbl(p)


def to_op_layout(x16: torch.Tensor) -> torch.Tensor:
    return lb.to_u32_layout(x16) if x16.is_cuda else x16


def from_op_layout(x: torch.Tensor) -> torch.Tensor:
    return lb.to_u16_layout(x) if x.is_cuda else x


def infinity_like(shape_prefix, batch: int, device) -> torch.Tensor:
    """All-zero Jacobian points [..., 3, *, batch] in the op layout."""
    device = torch.device(device)
    if device.type == "cuda":
        shape = tuple(shape_prefix) + (3, kernels.NL, batch)
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return g1_ops.infinity_like(shape_prefix, batch, device)
