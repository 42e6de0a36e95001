"""Kernel routing: a CUDA tensor goes to its Hopper kernel
(`ops/kernels.py`), a CPU tensor to the plain version (`ops/g1_ops.py`).

The two sides hold points in different layouts: the kernels take
radix-2^32 int32 limbs, the plain versions radix-2^16 int64 limbs.
`to_op_layout` / `from_op_layout` convert between the public radix-2^16
layout and the one the ops of that device take, and `to_table_layout` /
`from_table_layout` do the same for the fixed-base table, which the
accumulation kernel reads as 96-byte rows [W N, 2, 12]. Callers convert
once per table or bucket array, not once per op. `ops/g1_ops.py` offers
the same names the MSM calls, with the identity layout, so code written
against this module runs the plain versions on any device when handed
`g1_ops`.
"""

import torch

from ..constants import num_windows
from . import g1_ops, kernels, limbs as lb


def fixedbase_table(points16, valid, c: int):
    """[2, 24, N] public affine basis + valid[N] -> (table in this
    device's table layout, valid[W N]): on a CUDA device the kernel writes
    the accumulation's rows [W N, 2, 12] in one launch; on the CPU the
    plain version gives the public [2, 24, W N]."""
    if points16.is_cuda:
        rows = kernels.fixedbase_table(lb.to_u32_layout(points16), valid.contiguous(), c)
        return rows, valid.repeat(num_windows(c))
    return g1_ops.fixedbase_table(points16, valid, c)


def bucket_accumulate(table, order, bstart, c: int, groups: int):
    if table.is_cuda:
        return kernels.bucket_accumulate(table, order, bstart, c, groups)
    return g1_ops.bucket_accumulate(table, order, bstart, c, groups)


def bucket_reduce(buckets, c: int, groups: int):
    if buckets.is_cuda:
        return kernels.bucket_reduce(buckets, c, groups)
    return g1_ops.bucket_reduce(buckets, c, groups)


def to_op_layout(x16: torch.Tensor) -> torch.Tensor:
    return lb.to_u32_layout(x16) if x16.is_cuda else x16


def from_op_layout(x: torch.Tensor) -> torch.Tensor:
    return lb.to_u16_layout(x) if x.is_cuda else x


def to_table_layout(table16: torch.Tensor) -> torch.Tensor:
    """[2, 24, W N] public affine table -> the accumulation's layout."""
    if not table16.is_cuda:
        return table16
    return lb.to_u32_layout(table16).permute(2, 0, 1).contiguous()


def from_table_layout(table: torch.Tensor) -> torch.Tensor:
    if not table.is_cuda:
        return table
    return lb.to_u16_layout(table.permute(1, 2, 0))
