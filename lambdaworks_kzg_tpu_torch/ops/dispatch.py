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

The routes of the batched G1 steps (`ops/g1_batch.py`) take and return
the public layout and convert around each launch: `decompress_xy`,
`scalar_mul`, `scalar_mul_endo`, `subgroup_mask` and `add` run once per
batch or per FFT stage, not in a loop of ops. `fft_stage_endo` takes and
returns the op layout, so the conversion's FFT converts once before its
stages and once after them.

`pairing_miller_loop` and `pairing_final_exp` are the pairing tier's two
steps (`ops/pairing_ops.py`), public layout in and out.

`resolve_device` turns a device argument into a `torch.device` and
raises where CUDA is asked for and absent: the entry points run on the
card unless the caller asks for the CPU.
"""

import torch

from ..constants import num_windows
from . import g1_ops, kernels, limbs as lb, pairing_ops


def resolve_device(device) -> torch.device:
    """A torch.device; CUDA that is not there raises (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return device


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


# -- the batched G1 steps, public layout in and out ------------------------


def decompress_xy(x16, want_largest):
    """x [24, B] Montgomery + want_largest bool[B] -> (y [24, B], qr bool[B])."""
    if x16.is_cuda:
        y, qr = kernels.decompress(lb.to_u32_layout(x16), want_largest.contiguous())
        return lb.to_u16_layout(y), qr
    return g1_ops.decompress_xy(x16, want_largest)


def scalar_mul(points16, scalars16, nbits: int):
    """[3, 24, B] Jacobian, [16, B] or [16, 1] plain scalars -> [k_b] P_b."""
    if points16.is_cuda:
        out = kernels.scalar_mul(lb.to_u32_layout(points16), lb.to_u32_layout(scalars16), nbits)
        return lb.to_u16_layout(out)
    return g1_ops.scalar_mul(points16, scalars16, nbits)


def scalar_mul_endo(points16, split16):
    """[3, 24, B] Jacobian points of G1, [16, B] or [16, 1] split scalars
    (k1 in limbs 0-7, k2 in limbs 8-15) -> [k1 + k2 x^2] P_b."""
    if points16.is_cuda:
        out = kernels.scalar_mul(lb.to_u32_layout(points16), lb.to_u32_layout(split16), 128,
                                 split=True)
        return lb.to_u16_layout(out)
    return g1_ops.scalar_mul_endo(points16, split16)


def fft_stage_endo(a, length: int, split16):
    """One stage of the conversion's FFT on points of G1 [3, *, n] in the op
    layout, with split twiddles [16, n/2] (public limbs) -> the op layout."""
    if a.is_cuda:
        return kernels.fft_stage(a, length, lb.to_u32_layout(split16))
    return g1_ops.fft_stage_endo(a, length, split16)


def subgroup_mask(points16):
    """[3, 24, B] Jacobian -> bool[B], P in G1."""
    if points16.is_cuda:
        return kernels.subgroup_mask(lb.to_u32_layout(points16))
    return g1_ops.subgroup_mask(points16)


def add(p16, q16):
    """Complete Jacobian add of [3, 24, B] points."""
    if p16.is_cuda:
        return lb.to_u16_layout(kernels.add(lb.to_u32_layout(p16), lb.to_u32_layout(q16)))
    return g1_ops.add(p16, q16)


# -- the pairing tier's two steps -------------------------------------------


def pairing_miller_loop(ps16, qs16):
    """G1 [3, 24, B] and G2 [3, 2, 24, B] Jacobian -> the Miller values
    [12, 24, B] (`tower_ops.flatten12`), one at lanes with a member at
    infinity."""
    if ps16.is_cuda:
        f = kernels.miller_loop(lb.to_u32_layout(ps16), lb.to_u32_layout(qs16))
        return lb.to_u16_layout(f)
    return pairing_ops.miller_loop_jac(ps16, qs16)


def pairing_final_exp(f16):
    """Miller values [12, 24, B] -> (FE(prod f)^3 [12, 24, 1], == 1 as bool[1])."""
    if f16.is_cuda:
        fe, ok = kernels.final_exp(lb.to_u32_layout(f16))
        return lb.to_u16_layout(fe), ok
    return pairing_ops.final_exp_check(f16)
