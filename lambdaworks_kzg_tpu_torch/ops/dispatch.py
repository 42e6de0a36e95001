"""Kernel routing: a CUDA tensor goes to its Hopper kernel
(`ops/kernels.py`), a CPU tensor to the plain version (`ops/g1_ops.py`).

The two sides hold points in different layouts: the kernels take
radix-2^32 int32 limbs, the plain versions radix-2^16 int64 limbs.
`to_op_layout` / `from_op_layout` convert between the public radix-2^16
layout and the one the ops of that device take, and `to_table_layout` /
`from_table_layout` do the same for rows of points: the fixed-base table
or the generic MSM's points, which the accumulation kernel reads as
96-byte rows [M, 2, 12], and its chunk partials, 144-byte rows [B K, 3,
12]. Callers convert once per table or bucket array, not once per op.
`combine_windows` takes the reduce's window sums in the op layout as
they come. `ops/g1_ops.py` offers
the same names the MSM calls, with the identity layout, so code written
against this module runs the plain versions on any device when handed
`g1_ops`.

The routes of the batched G1 steps (`ops/g1_batch.py`) take and return
the public layout and convert around each launch: `decompress_xy`,
`scalar_mul`, `scalar_mul_endo`, `subgroup_mask` and `add` run once per
batch or per FFT stage, not in a loop of ops. `fold`, the mesh's fold of
its partials, takes the public layout as it is. `fft_stage_endo` takes and
returns the op layout, so the conversion's FFT converts once before its
stages and once after them.

`pairing_miller_loop` and `pairing_final_exp` are the pairing tier's two
steps (`ops/pairing_ops.py`), public layout in and out.

`fr_to_mont`, `fr_evaluate`, `fr_quotient` and `fr_quotient_in_domain`
run the Fr layer's kernels on CUDA tensors only, with any leading batch
dimensions flattened into the kernels' blob axis: `fr_to_mont` public
layout in and out around the kernel layout, the other three on the
plain public limbs as they are (their kernels read and write that
layout), each z a row of `FrDomain.z_table` (`FrDomain.root_table` for
a z in the domain); `fr_open` runs a batch's evaluation and quotient,
two launches and no conversion.
`ops/fr_poly.FrDomain` routes a CUDA tensor here and keeps the plain
versions for the CPU.

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


def accumulate_chunks(table, order, bstart, c: int, chunk: int):
    """Chunk partials: rows [B K, 3, 12] from the kernel on a CUDA device,
    [3, 24, B K] from the plain version on the CPU."""
    if table.is_cuda:
        return kernels.bucket_accumulate(table, order, bstart, c, chunk)
    return g1_ops.accumulate_chunks(table, order, bstart, c, chunk)


def reduce_chunks(partials, bstart, c: int, chunk: int, n_members: int):
    """-> [3, *, B] in this device's op layout; the kernel overwrites its
    partials (the merge runs in place)."""
    if partials.is_cuda:
        return kernels.bucket_reduce(partials, bstart, c, chunk, n_members)
    return g1_ops.reduce_chunks(partials, bstart, c, chunk, n_members)


def combine_windows(sums, c: int, windows: int):
    """Window sums [3, *, B W] in this device's op layout (MSM b's window
    w at b W + w) -> [3, *, B]: one g1_window_combine launch on a CUDA
    device, its plain version (the same runs of windows) on the CPU."""
    if sums.is_cuda:
        return kernels.window_combine(sums, c, windows)
    return g1_ops.combine_windows(sums, c, windows)


def to_op_layout(x16: torch.Tensor) -> torch.Tensor:
    return lb.to_u32_layout(x16) if x16.is_cuda else x16


def from_op_layout(x: torch.Tensor) -> torch.Tensor:
    return lb.to_u16_layout(x) if x.is_cuda else x


def to_table_layout(table16: torch.Tensor) -> torch.Tensor:
    """[C, 24, M] public points (the affine table, chunk partials) -> the
    kernels' rows [M, C, 12]."""
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


def fold(points16):
    """[K, 3, 24, B] Jacobian points folded over the leading axis ->
    [3, 24, B] (`g1_ops.fold`): one g1_fold launch on the public limbs on
    a card, none for one row."""
    if points16.shape[0] == 1:
        return points16[0]
    if points16.is_cuda:
        return kernels.fold(points16.contiguous())
    return g1_ops.fold(points16)


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


# -- the Fr layer's kernels (CUDA tensors), public layout in and out -------


def fr_to_mont(plain16):
    """Plain Fr limbs [..., 16, n] on a card -> Montgomery [..., 16, n]."""
    rows = lb.to_u32_layout(plain16).reshape(-1, kernels.FR_NL, plain16.shape[-1])
    return lb.to_u16_layout(kernels.fr_to_mont(rows)).reshape(plain16.shape)


def fr_evaluate(evals16, table, roots, n_inv):
    """Plain evaluations [..., 16, n] on a card, the z table of their
    B = prod(...) blobs [B, 8, levels + 1] (`FrDomain.z_table`), the
    domain's roots [8, n] and 1/n [8, 1] in the kernel layout -> PLAIN y
    [..., 16, 1]."""
    lead, n = evals16.shape[:-2], evals16.shape[-1]
    y = kernels.fr_evaluate(evals16.reshape(-1, 16, n).contiguous(), table, roots, n_inv)
    return y.reshape(tuple(lead) + (16, 1))


def fr_quotient(evals16, y16, table, roots):
    """Plain evaluations [..., 16, n] and y [..., 16, 1] on a card, the z
    table of their blobs, roots [8, n] -> PLAIN q [..., 16, n]."""
    lead, n = evals16.shape[:-2], evals16.shape[-1]
    q = kernels.fr_quotient(evals16.reshape(-1, 16, n).contiguous(),
                            y16.reshape(-1, 16, 1).contiguous(), table, roots)
    return q.reshape(tuple(lead) + (16, n))


def fr_quotient_in_domain(evals16, m, table, roots):
    """Plain evaluations [..., 16, n] on a card, the index m of each blob's
    z = w_m as B = prod(...) host ints, the table of those blobs
    [B, 8, levels + 3] (`FrDomain.root_table`), roots [8, n] -> PLAIN q
    [..., 16, n]."""
    lead, n = evals16.shape[:-2], evals16.shape[-1]
    q = kernels.fr_quotient_in_domain(evals16.reshape(-1, 16, n).contiguous(), m, table, roots)
    return q.reshape(tuple(lead) + (16, n))


def fr_open(plain16, table, roots, n_inv, quotient: bool = True):
    """Plain evaluations [B, 16, n] on a card and their z table
    (`FrDomain.z_table`), z outside the domain -> (PLAIN q [B, 16, n], or
    None where quotient is False, and PLAIN y [B, 16, 1]): fr_evaluate,
    then fr_quotient on the same limbs, table and y."""
    plain16 = plain16.contiguous()  # as blob_scalars makes them: no copy
    y = kernels.fr_evaluate(plain16, table, roots, n_inv)
    q = kernels.fr_quotient(plain16, y, table, roots) if quotient else None
    return q, y
