"""G1 point operations in plain PyTorch: the plain versions of the five
CUDA kernels (`ops/kernels.py`), and the CPU path. `madd`, `add` and `dbl`
are the point ops; `bucket_accumulate` and `bucket_reduce` are the
fixed-base MSM's two stages, written over them as the JAX package writes
them (`ops/msm.py` `msm_fixedbase_device`, `_bucket_reduce_fold`,
`_tree_sum_lanes`).

Points are Jacobian (X, Y, Z) in Montgomery form, one [..., 3, L, B]
radix-2^16 int64 tensor (coordinate, limb, lane); infinity is Z == 0.
Affine inputs are [..., 2, L, B] with a separate validity mask. The
exceptional lanes are patched with the same selects as the JAX
package's `ops/g1_ops.py`, so every output limb, Z included, equals
the JAX result.
"""

import numpy as np
import torch

from .field_ops import FP
from .formulas import jacobian_add_core, jacobian_dbl, jacobian_madd_core

L = FP.L  # 24


def make_points_host(affine_list):
    """[(x, y) | None, ...] -> (uint32[2, L, N] Montgomery affine
    coordinates, bool[N] valid), numpy. Infinity rows are zeros."""
    xs = [0 if pt is None else pt[0] for pt in affine_list]
    ys = [0 if pt is None else pt[1] for pt in affine_list]
    out = np.stack([FP.to_mont_host(xs), FP.to_mont_host(ys)], axis=0)
    valid = np.asarray([pt is not None for pt in affine_list], dtype=bool)
    out[:, :, ~valid] = 0
    return out, valid


def points_to_host(points) -> list:
    """Jacobian [..., 3, L, B] Montgomery limbs -> list of (X, Y, Z) ints."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    arr = np.asarray(points)
    arr = arr.reshape((-1,) + arr.shape[-3:])
    out = []
    for g in range(arr.shape[0]):
        xs, ys, zs = (FP.from_mont_host(arr[g, k]) for k in range(3))
        out.extend(zip(xs, ys, zs))
    return out


def infinity_like(shape_prefix, batch: int, device="cpu") -> torch.Tensor:
    return torch.zeros(
        tuple(shape_prefix) + (3, L, batch), dtype=torch.int64, device=device
    )


def lift(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Affine [2, L, N] + valid -> Jacobian [3, L, N] (Z = 1 or 0)."""
    z = torch.where(valid.unsqueeze(0), FP.one_like(points[0]), 0)
    return torch.stack([points[0], points[1], z], dim=0)


def _sel_pt(mask, a, b):
    """mask ? a : b over [..., C, L, B] point tensors; mask [..., B]."""
    return torch.where(mask.unsqueeze(-2).unsqueeze(-2), a, b)


def dbl(p: torch.Tensor) -> torch.Tensor:
    """Jacobian doubling (dbl-2009-l)."""
    return torch.stack(jacobian_dbl(FP, *p.unbind(-3)), dim=-3)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian + Jacobian addition (add-2007-bl + selects)."""
    X1, Y1, Z1 = p.unbind(-3)
    X3, Y3, Z3, H, Rr = jacobian_add_core(FP, X1, Y1, Z1, *q.unbind(-3))
    out = torch.stack([X3, Y3, Z3], dim=-3)
    p_inf = FP.is_zero(Z1)
    q_inf = FP.is_zero(q[..., 2, :, :])
    same_x = ~p_inf & ~q_inf & FP.is_zero(H)
    if bool(same_x.any()):
        r_zero = FP.is_zero(Rr)
        out = _sel_pt(same_x & r_zero, dbl(p), out)
        out = _sel_pt(same_x & ~r_zero, torch.zeros_like(out), out)
    out = _sel_pt(p_inf, q, out)
    return _sel_pt(q_inf, p, out)


def madd(p: torch.Tensor, q_aff: torch.Tensor, q_valid: torch.Tensor) -> torch.Tensor:
    """Complete mixed addition: Jacobian p + affine q (madd-2007-bl).
    Lanes with q_valid False pass p through."""
    X1, Y1, Z1 = p.unbind(-3)
    X2, Y2 = q_aff.unbind(-3)
    X3, Y3, Z3, H, Rr = jacobian_madd_core(FP, X1, Y1, Z1, X2, Y2)
    out = torch.stack([X3, Y3, Z3], dim=-3)
    p_inf = FP.is_zero(Z1)
    same_x = q_valid & ~p_inf & FP.is_zero(H)
    if bool(same_x.any()):
        r_zero = FP.is_zero(Rr)
        out = _sel_pt(same_x & r_zero, dbl(p), out)
        out = _sel_pt(same_x & ~r_zero, torch.zeros_like(out), out)
    q_jac = torch.stack([X2, Y2, FP.one_like(X2)], dim=-3)
    out = _sel_pt(p_inf & q_valid, q_jac, out)
    return _sel_pt(~q_valid, p, out)


# -- the fixed-base MSM's stages (plain versions of csrc/msm.cu) -----------


def bucket_accumulate(table, order, bstart, c: int, groups: int) -> torch.Tensor:
    """Lock-step bucket accumulation over a batch of blobs.

    table: [2, L, W N] affine rows; order: [B, W N] member indices in
    digit-sorted order per blob; bstart: [B, 2^c] where bucket j's run
    starts (it ends where j + 1's starts, the last at W N). Returns
    buckets [3, L, B G 2^c]: lane (b, g, j) sums the members
    bstart[b, j] + g + t G < bend[b, j] of blob b in round order t, one
    `madd` per round over every lane; bucket 0 stays at infinity."""
    n_blobs, n_members = order.shape
    nb = 1 << c
    order, bstart = order.long(), bstart.long()
    bend = torch.cat([bstart[:, 1:], bstart.new_full((n_blobs, 1), n_members)], dim=1)
    buckets = infinity_like((), n_blobs * groups * nb, table.device)
    longest = int((bend - bstart)[:, 1:].max()) if n_blobs and n_members else 0
    g = torch.arange(groups, device=table.device)[None, :, None]
    live_bucket = torch.arange(nb, device=table.device) != 0
    for t in range((longest + groups - 1) // groups):
        idx = bstart[:, None, :] + g + t * groups  # [B, G, 2^c]
        live = (idx < bend[:, None, :]) & live_bucket
        member = torch.gather(order, 1, idx.clamp(max=n_members - 1).reshape(n_blobs, -1))
        buckets = madd(buckets, table.index_select(-1, member.reshape(-1)), live.reshape(-1))
    return buckets


def _flat(arr4: torch.Tensor) -> torch.Tensor:
    """[C, L, W, k] -> contiguous [C, L, W k]."""
    s = arr4.shape
    return arr4.reshape(s[:-2] + (s[-2] * s[-1],)).contiguous()


def tree_sum_lanes(arr4: torch.Tensor) -> torch.Tensor:
    """Pairwise point sum over the last axis of [C, L, W, k] (k a power
    of two) -> [C, L, W]: log2(k) halving adds."""
    k = arr4.shape[-1]
    if k & (k - 1):
        raise ValueError("tree width must be a power of two")
    while arr4.shape[-1] > 1:
        half = arr4.shape[-1] // 2
        lo = _flat(arr4[..., :half])
        hi = _flat(arr4[..., half : 2 * half])
        arr4 = add(lo, hi).reshape(arr4.shape[:-1] + (half,))
    return arr4[..., 0].contiguous()


def zero_bucket0(buckets: torch.Tensor, c: int) -> torch.Tensor:
    """Clear the bucket-0 lanes (weight 0; invalid members land there)."""
    b_idx = torch.arange(buckets.shape[-1], device=buckets.device) % (1 << c)
    return torch.where(b_idx == 0, torch.zeros_like(buckets), buckets)


def fold_reduce(buckets: torch.Tensor, c: int) -> torch.Tensor:
    """[C, L, W 2^c] buckets -> [C, L, W] sums S_w = sum_b b B_{w,b}.

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
        totals.append(tree_sum_lanes(hi))
        arr4 = add(_flat(lo), _flat(hi)).reshape(lo.shape)
        h //= 2
    acc = totals[0]
    for e in totals[1:]:
        acc = add(dbl(acc), e)
    return acc


def bucket_reduce(buckets: torch.Tensor, c: int, groups: int) -> torch.Tensor:
    """[3, L, B G 2^c] buckets -> [3, L, B]: the fold reduce of every
    (blob, group), then each blob's G group sums added pairwise."""
    sums = fold_reduce(buckets, c)  # [3, L, B G]
    return tree_sum_lanes(sums.reshape(sums.shape[:-1] + (-1, groups)))


# -- the op-namespace interface of ops/dispatch.py, identity layout ---------


def to_op_layout(x16: torch.Tensor) -> torch.Tensor:
    return x16


def from_op_layout(x: torch.Tensor) -> torch.Tensor:
    return x
