"""Fixed-base Pippenger MSM over the trusted setup's commitment basis.

The port of the fixed-base part of the JAX package's `ops/msm.py`
(`build_fixedbase_tables`, `msm_fixedbase_device`; its fold
`bucket_reduce` and `_tree_sum_lanes` are `g1_ops.bucket_reduce`, the
plain version of the reduce kernel). The basis is fixed for the life
of a setup, so each window's shift [2^(c w)] P_i is precomputed once; the
MSM then feeds all W N (digit, shifted point) pairs into one 2^c-bucket
grid, split over `groups` lane groups, and needs no Horner combine over
windows. A batch of blobs shares one sort, one bucket accumulation and
one reduce.

Every function takes `ops`, the point-op namespace: `ops/dispatch.py`
(the default: Hopper kernels for CUDA tensors, plain versions on the
CPU) or `ops/g1_ops.py` (the plain versions on any device). Point
tensors stay in `ops`' layout from the first op to the last.
"""

import numpy as np
import torch

from ..constants import P, R
from ..host import field as HF
from . import dispatch, g1_ops, limbs as lb
from .field_ops import FP


def num_windows(c: int) -> int:
    return (256 + c - 1) // c


def window_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """[..., 16, N] plain Fr limbs (int64) -> digits [..., W, N] (int64),
    digit w = (scalar >> (c w)) & (2^c - 1); c <= 16."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    padded = torch.cat([scalars, torch.zeros_like(scalars[..., :1, :])], dim=-2)
    # window w starts at bit c w: limb k = c w // 16, shift s = c w % 16;
    # with c <= 16 it lies inside limbs k and k + 1. All windows at once,
    # a few tensor ops instead of a few per window.
    start = torch.arange(num_windows(c), device=scalars.device) * c
    k, s = start // 16, (start % 16)[:, None]
    word = padded.index_select(-2, k) | (padded.index_select(-2, k + 1) << 16)
    return (word >> s) & ((1 << c) - 1)


def fixedbase_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """[..., 16, N] -> flat digits [..., W N]; member (w, i) at w N + i,
    the layout of `build_fixedbase_tables`."""
    return window_digits(scalars, c).flatten(-2)


def jacobian_to_affine(jac16: torch.Tensor) -> torch.Tensor:
    """[3, 24, M] Montgomery Jacobian -> [2, 24, M] Montgomery affine on
    the same device; infinity lanes become (0, 0).

    The inversion is Montgomery's batch trick over Python ints on the
    host: one exponentiation and three products per lane."""
    arr = jac16.detach().cpu().numpy()
    X, Y, Z = (FP.from_mont_host(arr[k]) for k in range(3))
    zinv = HF.batch_fp_inv(Z)
    xs, ys = [], []
    for x, y, zi in zip(X, Y, zinv):
        zi2 = zi * zi % P
        xs.append(x * zi2 % P)
        ys.append(y * zi2 % P * zi % P)
    out = np.stack([FP.to_mont_host(xs), FP.to_mont_host(ys)], axis=0)
    return lb.as_limb_tensor(out, jac16.device)


def build_fixedbase_tables(points: torch.Tensor, valid: torch.Tensor, c: int,
                           ops=dispatch):
    """[2, 24, N] Montgomery affine + valid[N] -> ([2, 24, W N] affine
    table, valid[W N]); entry (w, i) = [2^(c w)] P_i, and invalid source
    lanes stay invalid (and zero) in every window."""
    w_count = num_windows(c)
    cur = ops.to_op_layout(g1_ops.lift(points, valid))
    shifted = []
    for w in range(w_count):
        shifted.append(cur)
        if w + 1 < w_count:
            for _ in range(c):
                cur = ops.dbl(cur)
    all_jac = ops.from_op_layout(torch.cat(shifted, dim=-1))
    return jacobian_to_affine(all_jac), valid.repeat(w_count)


def sort_members(digits: torch.Tensor, c: int):
    """digits [B, M] -> (order, bstart), int32: each blob's member indices
    in stable digit order [B, M], and where bucket j's run starts in it
    [B, 2^c]."""
    # 32-bit keys: half the radix passes of int64 (digits are below 2^16)
    sorted_digits, order = torch.sort(digits.to(torch.int32), dim=-1, stable=True)
    bucket_ids = torch.arange(1 << c, dtype=torch.int32, device=digits.device)
    bstart = torch.searchsorted(
        sorted_digits, bucket_ids.expand(digits.shape[0], -1).contiguous(), out_int32=True
    )
    return order.to(torch.int32), bstart


def msm_fixedbase_device(table: torch.Tensor, table_valid: torch.Tensor,
                         scalars: torch.Tensor, c: int = 8, groups: int = 8,
                         ops=dispatch) -> torch.Tensor:
    """Fixed-base MSM of B blobs -> Jacobian points [3, *, B] in `ops`'
    layout (B = 1 for [16, N] scalars).

    table: the affine table in `ops`' table layout (`to_table_layout`);
    scalars: [B, 16, N] or [16, N] plain Fr limbs (int64) on the table's
    device. Each blob's members are sorted by digit; bucket b's run is
    dealt round-robin to the lane groups (lane (g, b), stride G), so each
    group-bucket takes ceil(k_b / G) members (`bucket_accumulate`). The
    reduce folds every group's buckets and adds the group sums: the window
    weights are in the table. Nothing is read back to the host."""
    if scalars.dim() == 2:
        scalars = scalars[None]
    digits = fixedbase_digits(scalars, c)
    digits = torch.where(table_valid, digits, torch.zeros_like(digits))
    order, bstart = sort_members(digits, c)
    buckets = ops.bucket_accumulate(table, order, bstart, c, groups)
    return ops.bucket_reduce(buckets, c, groups)


def msm_fixedbase(table, table_valid, scalars, c: int = 8, groups: int = 8,
                  ops=dispatch):
    """Fixed-base MSM -> host Jacobian point (Python ints) for [16, N]
    scalars, or a list of B points for [B, 16, N], in one transfer."""
    pt = msm_fixedbase_device(table, table_valid, scalars, c, groups, ops)
    points = g1_ops.points_to_host(ops.from_op_layout(pt))
    return points if scalars.dim() == 3 else points[0]


def scalars_to_tensor(scalar_ints, device="cpu") -> torch.Tensor:
    """Python ints (mod r) -> [16, N] plain Fr limbs, int64."""
    return lb.as_limb_tensor(
        lb.ints_to_limbs([s % R for s in scalar_ints], 16), device
    )
