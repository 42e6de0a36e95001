"""Fixed-base Pippenger MSM over the trusted setup's commitment basis.

The port of the fixed-base part of the JAX package's `ops/msm.py`
(`build_fixedbase_tables`, `msm_fixedbase_device`, the fold
`bucket_reduce` and `_tree_sum_lanes`). The basis is fixed for the life
of a setup, so each window's shift [2^(c w)] P_i is precomputed once; the
MSM then feeds all W N (digit, shifted point) pairs into one 2^c-bucket
grid, split over `groups` lane groups, and needs no Horner combine over
windows.

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
    """[16, N] plain Fr limbs (int64) -> digits [W, N] (int64),
    digit w = (scalar >> (c w)) & (2^c - 1); c <= 16."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    padded = torch.cat([scalars, torch.zeros_like(scalars[:1])], dim=0)
    mask = (1 << c) - 1
    outs = []
    for w in range(num_windows(c)):
        k, s = divmod(c * w, 16)
        word = padded[k] | (padded[k + 1] << 16)
        outs.append((word >> s) & mask)
    return torch.stack(outs, dim=0)


def fixedbase_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """[16, N] -> flat digits [W N]; member (w, i) at w N + i, the
    layout of `build_fixedbase_tables`."""
    return window_digits(scalars, c).reshape(-1)


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


def _flat(arr4: torch.Tensor) -> torch.Tensor:
    """[C, L, W, k] -> contiguous [C, L, W k]."""
    s = arr4.shape
    return arr4.reshape(s[:-2] + (s[-2] * s[-1],)).contiguous()


def tree_sum_lanes(arr4: torch.Tensor, ops=dispatch) -> torch.Tensor:
    """Pairwise point sum over the last axis of [C, L, W, k] (k a power
    of two) -> [C, L, W]: log2(k) halving adds."""
    k = arr4.shape[-1]
    if k & (k - 1):
        raise ValueError("tree width must be a power of two")
    while arr4.shape[-1] > 1:
        half = arr4.shape[-1] // 2
        lo = _flat(arr4[..., :half])
        hi = _flat(arr4[..., half : 2 * half])
        arr4 = ops.add(lo, hi).reshape(arr4.shape[:-1] + (half,))
    return arr4[..., 0].contiguous()


def zero_bucket0(buckets: torch.Tensor, c: int) -> torch.Tensor:
    """Clear the bucket-0 lanes (weight 0; invalid members land there)."""
    b_idx = torch.arange(buckets.shape[-1], device=buckets.device) % (1 << c)
    return torch.where(b_idx == 0, torch.zeros_like(buckets), buckets)


def bucket_reduce(buckets: torch.Tensor, c: int, ops=dispatch) -> torch.Tensor:
    """[C, L, W 2^c] buckets -> [C, L, W] sums S_w = sum_b b B_{w,b}
    (the fold reduce; the fixed-base grid has no top-window aliases).

    Splitting the buckets at h = 2^(c-1) gives
      sum_b b B_b = sum_{j<h} j (B_j + B_{j+h}) + h sum_{j<h} B_{j+h},
    so each round folds the bucket axis in half and banks the high half's
    total E_r; the answer is the Horner combine sum_r 2^(c-r) E_r."""
    arr = zero_bucket0(buckets, c)
    nb = 1 << c
    arr4 = arr.reshape(arr.shape[:-1] + (arr.shape[-1] // nb, nb))
    totals = []
    h = nb // 2
    while h >= 1:
        lo = arr4[..., :h]
        hi = arr4[..., h : 2 * h]
        totals.append(tree_sum_lanes(hi, ops))
        arr4 = ops.add(_flat(lo), _flat(hi)).reshape(lo.shape)
        h //= 2
    acc = totals[0]
    for e in totals[1:]:
        acc = ops.add(ops.dbl(acc), e)
    return acc


def msm_fixedbase_device(table: torch.Tensor, table_valid: torch.Tensor,
                         scalars: torch.Tensor, c: int = 8, groups: int = 8,
                         ops=dispatch) -> torch.Tensor:
    """Fixed-base MSM -> one Jacobian point [3, *, 1] in `ops`' layout.

    table: [2, *, W N] affine table in `ops`' layout; scalars: [16, N]
    plain Fr limbs (int64) on the table's device. Members are sorted by
    digit; bucket b's run is dealt round-robin to the lane groups (lane
    (g, b), stride G), so each group-bucket takes ceil(k_b / G) members
    in lock-step madd rounds. The group sums then add up: the window
    weights are in the table."""
    device = table.device
    n_members = table.shape[-1]
    nb = 1 << c
    digits = fixedbase_digits(scalars, c)
    digits = torch.where(table_valid, digits, torch.zeros_like(digits))
    sorted_digits, order = torch.sort(digits, stable=True)
    bucket_ids = torch.arange(nb, dtype=sorted_digits.dtype, device=device)
    bstart = torch.searchsorted(sorted_digits, bucket_ids, side="left")
    bend = torch.cat([bstart[1:], bstart.new_tensor([n_members])])
    counts = bend - bstart
    max_load = int((counts[1:].max() + groups - 1) // groups)

    buckets = ops.infinity_like((), groups * nb, device)
    if max_load:
        t = torch.arange(max_load, device=device)[:, None, None]
        g = torch.arange(groups, device=device)[None, :, None]
        idx = bstart[None, None, :] + g + t * groups  # [T, G, 2^c]
        live = (idx < bend) & (bucket_ids != 0)
        member = order[idx.clamp(max=n_members - 1)]
        member = member.reshape(max_load, groups * nb)
        live = live.reshape(max_load, groups * nb)
        for r in range(max_load):
            gathered = table.index_select(-1, member[r])
            buckets = ops.madd(buckets, gathered, live[r])
    group_sums = bucket_reduce(buckets, c, ops)  # [3, *, G]
    return tree_sum_lanes(group_sums.reshape(group_sums.shape[:-1] + (1, groups)), ops)


def msm_fixedbase(table, table_valid, scalars, c: int = 8, groups: int = 8,
                  ops=dispatch):
    """Fixed-base MSM -> host Jacobian point (Python ints)."""
    pt = msm_fixedbase_device(table, table_valid, scalars, c, groups, ops)
    return g1_ops.points_to_host(ops.from_op_layout(pt))[0]


def scalars_to_tensor(scalar_ints, device="cpu") -> torch.Tensor:
    """Python ints (mod r) -> [16, N] plain Fr limbs, int64."""
    return lb.as_limb_tensor(
        lb.ints_to_limbs([s % R for s in scalar_ints], 16), device
    )
