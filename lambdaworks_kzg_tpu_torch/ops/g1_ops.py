"""G1 point operations in plain PyTorch: the plain versions of the CUDA
kernels' G1 functions (`ops/kernels.py`), and the CPU path. `madd`, `add`
and `dbl` are the point ops; `bucket_accumulate` and `bucket_reduce` are
the fixed-base MSM's two stages, written over them as the JAX package
writes them (`ops/msm.py` `msm_fixedbase_device`, `_bucket_reduce_fold`,
`_tree_sum_lanes`), and `accumulate_chunks` and `reduce_chunks` the
balanced schedule the MSM kernels run instead (chunks of at most L
members a lane, their partials merged pairwise before the same fold);
`combine_windows` is the generic MSM's sum of its window sums (JAX
`combine_windows_host`) on the combine kernel's schedule of runs;
`fixedbase_table` builds the MSM's table, as
`build_fixedbase_tables` does there. `decompress_xy`, `scalar_mul` and
`subgroup_mask` are the batched G1 steps of the JAX package's
`ops/g1_batch.py` (`_xy_from_x` + `_pick_sign`, the `fori_loop`s of
`scalar_mul_fixed` / `scalar_mul_per_lane`, `subgroup_mask` with
`_jacobian_eq_mask`), which `ops/g1_batch.py` here drives;
`scalar_mul_endo` is the schedule of the kernel's split mode, for points
in G1, and `fft_stage_endo` one stage of the setup conversion's FFT over
it (the kernel g1_fft_stage).

Points are Jacobian (X, Y, Z) in Montgomery form, one [..., 3, L, B]
radix-2^16 int64 tensor (coordinate, limb, lane); infinity is Z == 0.
Affine inputs are [..., 2, L, B] with a separate validity mask. The
exceptional lanes are patched with the same selects as the JAX
package's `ops/g1_ops.py`, so every output limb, Z included, equals
the JAX result.
"""

import numpy as np
import torch

from ..constants import BLS_X, B_G1_MONT, FP_HALF, FP_SQRT_EXP, G1_BETA, num_windows
from . import limbs as lb
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


def _gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[..., C, L, B] -> [C, L, len(idx)]: the lanes idx of the flat
    (leading, B) lane order."""
    c, limbs, b = x.shape[-3:]
    flat = x.reshape(-1, c, limbs, b).permute(1, 2, 0, 3).reshape(c, limbs, -1)
    return flat.index_select(-1, idx)


def _scatter_lanes(part: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """[C, L, len(idx)] lanes -> [*shape] zeros elsewhere (`_gather_lanes`' inverse)."""
    c, limbs, b = shape[-3:]
    flat = part.new_zeros(c, limbs, torch.Size(shape[:-3]).numel() * b)
    flat[..., idx] = part
    return flat.reshape(c, limbs, -1, b).permute(2, 0, 1, 3).reshape(shape)


def _finite_sum(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q on lanes where neither is at infinity (add-2007-bl; the
    same x doubles, or gives infinity)."""
    X3, Y3, Z3, H, Rr = jacobian_add_core(FP, *p.unbind(-3), *q.unbind(-3))
    out = torch.stack([X3, Y3, Z3], dim=-3)
    same_x = FP.is_zero(H)
    if bool(same_x.any()):
        r_zero = FP.is_zero(Rr)
        out = _sel_pt(same_x & r_zero, dbl(p), out)
        out = _sel_pt(same_x & ~r_zero, torch.zeros_like(out), out)
    return out


def _on_live_lanes(live: torch.Tensor, fn, p: torch.Tensor, *others) -> torch.Tensor:
    """fn(p, *others) on the lanes where `live` holds, zeros elsewhere
    (lanes the caller overwrites): only the live lanes are gathered,
    computed and scattered back, so that sums of mostly infinite buckets
    cost what their finite lanes cost."""
    assert all(o.shape[:-3] == p.shape[:-3] and o.shape[-1] == p.shape[-1] for o in others)
    idx = torch.nonzero(live.reshape(-1)).reshape(-1)
    part = fn(_gather_lanes(p, idx), *(_gather_lanes(o, idx) for o in others))
    return _scatter_lanes(part, idx, p.shape[:-3] + (3,) + p.shape[-2:])


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian + Jacobian addition (add-2007-bl + selects)."""
    p_inf = FP.is_zero(p[..., 2, :, :])
    q_inf = FP.is_zero(q[..., 2, :, :])
    out = _on_live_lanes(~p_inf & ~q_inf, _finite_sum, p, q)
    out = _sel_pt(p_inf, q, out)
    return _sel_pt(q_inf, p, out)


def fold(points: torch.Tensor) -> torch.Tensor:
    """Fold [K, 3, L, B] Jacobian points over the leading axis with
    complete adds -> [3, L, B]: each level adds row j to row half + j,
    j < half = K // 2, over all lanes at once; an odd last row waits for
    the next level (JAX `parallel/msm.py` `_tree_fold_points`)."""
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        folded = add(points[:half], points[half:2 * half])
        if points.shape[0] % 2:
            folded = torch.cat([folded, points[2 * half:]])
        points = folded
    return points[0]


def _finite_mixed_sum(p: torch.Tensor, q_aff: torch.Tensor) -> torch.Tensor:
    """p + affine q on lanes where q is valid and p not at infinity
    (madd-2007-bl; the same x doubles, or gives infinity)."""
    X3, Y3, Z3, H, Rr = jacobian_madd_core(FP, *p.unbind(-3), *q_aff.unbind(-3))
    out = torch.stack([X3, Y3, Z3], dim=-3)
    same_x = FP.is_zero(H)
    if bool(same_x.any()):
        r_zero = FP.is_zero(Rr)
        out = _sel_pt(same_x & r_zero, dbl(p), out)
        out = _sel_pt(same_x & ~r_zero, torch.zeros_like(out), out)
    return out


def madd(p: torch.Tensor, q_aff: torch.Tensor, q_valid: torch.Tensor) -> torch.Tensor:
    """Complete mixed addition: Jacobian p + affine q (madd-2007-bl).
    Lanes with q_valid False pass p through."""
    p_inf = FP.is_zero(p[..., 2, :, :])
    out = _on_live_lanes(q_valid & ~p_inf, _finite_mixed_sum, p, q_aff)
    X2, Y2 = q_aff.unbind(-3)
    q_jac = torch.stack([X2, Y2, FP.one_like(X2)], dim=-3)
    out = _sel_pt(p_inf & q_valid, q_jac, out)
    return _sel_pt(~q_valid, p, out)


# -- the fixed-base MSM's stages as the JAX package schedules them ----------


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


# -- the balanced schedule of the MSM kernels (plain versions of csrc/msm.cu) --
#
# `bucket_accumulate` deals a bucket's members to G lanes, so digits that
# crowd into one bucket lengthen a lane's chain without bound. The kernels
# cut each blob's digit-sorted members into chunks of at most L that never
# cross a bucket boundary, one chunk a lane, and merge each bucket's chunk
# partials pairwise before the fold. The sums are reordered, so the
# buckets and the MSM equal the schedule above in affine form only.

SLOT_ALIGN = 128  # a blob's chunk slots: whole blocks of the accumulation kernel


def chunk_slots(n_members: int, c: int, chunk: int) -> int:
    """Chunk slots a blob of n_members takes at L = chunk: bucket j has
    ceil(k_j / L) <= k_j / L + 1 chunks, so ceil(M / L) + 2^c bounds them
    for any digits; rounded up to a multiple of SLOT_ALIGN."""
    k = -(-n_members // chunk) + (1 << c)
    return -(-k // SLOT_ALIGN) * SLOT_ALIGN


def chunk_plan(bstart: torch.Tensor, n_members: int, chunk: int):
    """bstart [B, 2^c] -> (first [B, 2^c + 1], bend [B, 2^c]), int64:
    bucket j's chunks are slots first[b, j] .. first[b, j + 1] - 1, chunk
    t of them holding the sorted members bstart[b, j] + t L .. min(+ L,
    bend[b, j]) - 1; bucket 0 (weight 0; invalid members) has none, and
    first[b, 2^c] is the blob's chunk count."""
    bstart = bstart.long()
    bend = torch.cat([bstart[:, 1:], bstart.new_full((bstart.shape[0], 1), n_members)], dim=1)
    chunks = (bend - bstart + chunk - 1) // chunk
    chunks[:, 0] = 0
    return torch.cat([chunks.new_zeros(chunks.shape[0], 1), chunks.cumsum(1)], dim=1), bend


def chunk_lanes(bstart: torch.Tensor, n_members: int, c: int, chunk: int):
    """Each chunk slot's (bucket, first member, member count), [B, K]
    int64 each: the slots past a blob's chunks have count 0."""
    first, bend = chunk_plan(bstart, n_members, chunk)
    slots = torch.arange(chunk_slots(n_members, c, chunk), device=bstart.device)
    slots = slots.expand(bstart.shape[0], -1).contiguous()
    live = slots < first[:, -1:]
    bucket = torch.searchsorted(first[:, 1:].contiguous(), slots, right=True).clamp(max=(1 << c) - 1)
    start = bstart.long().gather(1, bucket) + (slots - first.gather(1, bucket)) * chunk
    count = torch.where(live, (bend.gather(1, bucket) - start).clamp(max=chunk), 0)
    return bucket, start, count


def accumulate_chunks(table, order, bstart, c: int, chunk: int) -> torch.Tensor:
    """The balanced bucket accumulation over a batch of blobs.

    table: [2, L, W N] affine rows; order: [B, W N] member indices in
    digit-sorted order per blob; bstart: [B, 2^c] where bucket j's run
    starts. Returns chunk partials [3, L, B K], K = chunk_slots(W N, c,
    chunk): slot s of blob b (lane b K + s) sums its chunk's members in
    order, one `madd` per round over every lane (the first round lifts);
    slots past the blob's chunks stay at infinity."""
    n_blobs, n_members = order.shape
    _, start, count = chunk_lanes(bstart, n_members, c, chunk)
    acc = infinity_like((), count.numel(), table.device)
    order = order.long()
    for t in range(int(count.max()) if count.numel() else 0):
        member = order.gather(1, (start + t).clamp(max=n_members - 1))
        acc = madd(acc, table.index_select(-1, member.reshape(-1)), (count > t).reshape(-1))
    return acc


def merge_schedule(bstart: torch.Tensor, n_members: int, c: int, chunk: int) -> list:
    """The pairwise merge of each bucket's chunk partials, a tree in chunk
    order: per level, (left, right) index tensors over the flat [B K]
    slots. Level l adds slot left + 2^(l-1) into left, for each left at
    chunk t = 0 mod 2^l of a bucket with more than t + 2^(l-1) chunks; a
    node with no right child waits for the next level."""
    first, _ = chunk_plan(bstart, n_members, chunk)
    bucket, _, count = chunk_lanes(bstart, n_members, c, chunk)
    n_slots = bucket.shape[1]
    t = torch.arange(n_slots, device=bstart.device) - first.gather(1, bucket)
    chunks = first.gather(1, bucket + 1) - first.gather(1, bucket)
    flat = torch.arange(bucket.numel(), device=bstart.device).reshape(bucket.shape)
    levels, half = [], 1
    while True:
        pick = (count > 0) & (t % (2 * half) == 0) & (t + half < chunks)
        if not bool(pick.any()):
            return levels
        left = flat[pick]
        levels.append((left, left + half))
        half *= 2


def merge_chunks(partials, bstart, c: int, chunk: int, n_members: int) -> torch.Tensor:
    """Chunk partials [3, L, B K] -> bucket sums [3, L, B 2^c]: each
    bucket's partials merged by `merge_schedule`, the root in chunk 0's
    slot; infinity for an empty bucket and for bucket 0."""
    out = partials.clone()
    for left, right in merge_schedule(bstart, n_members, c, chunk):
        out[..., left] = add(out[..., left], out[..., right])
    first, _ = chunk_plan(bstart, n_members, chunk)
    n_blobs, nb = bstart.shape
    root = first[:, :nb] + torch.arange(n_blobs, device=bstart.device)[:, None] * (out.shape[-1] // n_blobs)
    buckets = out.index_select(-1, root.reshape(-1).clamp(max=out.shape[-1] - 1))
    filled = (first[:, 1:] > first[:, :nb]).reshape(-1)
    return _sel_pt(filled, buckets, torch.zeros_like(buckets))


def reduce_chunks(partials, bstart, c: int, chunk: int, n_members: int) -> torch.Tensor:
    """Chunk partials [3, L, B K] -> [3, L, B]: `merge_chunks`, then
    `fold_reduce` per blob."""
    return fold_reduce(merge_chunks(partials, bstart, c, chunk, n_members), c)


COMBINE_UNITS = 4  # g1_window_combine's runs at most: warps of a block (csrc/msm.cu kCombineUnits)


def combine_runs(windows: int, c: int) -> list:
    """The combine's partition of W windows at c bits into at most
    COMBINE_UNITS runs of consecutive windows -> their starts [0, lo_1, ..]
    (the kernel's combine_runs, csrc/msm.cu). In half doublings (an add
    ~3): the top run's doublings end at 2 c (W - 1); run j closes at the
    last window t whose chain, c t doublings and t - lo_j Horner adds, ends
    3 (COMBINE_UNITS - 1 - j) before that, so that the comb's adds above it
    are done in time; at least one window a run, and one left for the top
    run."""
    lo = [0]
    while len(lo) < COMBINE_UNITS and lo[-1] <= windows - 2:
        j = len(lo) - 1
        limit = 2 * c * (windows - 1) - 3 * (COMBINE_UNITS - 1 - j)
        t = (limit + 3 * lo[j]) // (2 * c + 3)
        lo.append(max(lo[j], min(t, windows - 2)) + 1)
    return lo


def combine_windows(sums: torch.Tensor, c: int, windows: int) -> torch.Tensor:
    """Window sums [3, L, B W] of B MSMs (MSM b's window w at lane b W +
    w) -> [3, L, B]: sum_w 2^(c w) S_w, as JAX `combine_windows_host`
    gives it in affine form, on the kernel g1_window_combine's schedule,
    of which this is the plain version step for step, Z included.

    The W windows are cut into G runs (`combine_runs`). Run j,
    windows lo_j .. top_j, is a Horner chain, acc = S_top, then for w =
    top - 1 .. lo_j c doublings and acc = add(acc, S_w), then c lo_j
    doublings more: D_j = 2^(c lo_j) T_j. The G runs are one lane axis,
    their doublings lined up at their ends: at window position w every run
    with top > w doubles c times (one `dbl` call a step over all runs, a
    select keeping the runs not yet started) and the run holding w adds
    S_w. Then the left comb P_0 = D_0, P_j = add(P_(j-1), D_j) (the last
    add the top run's)."""
    lo = combine_runs(windows, c)
    runs = len(lo)
    msms = sums.shape[-1] // windows
    dev = sums.device
    top = torch.tensor(lo[1:] + [windows], device=dev) - 1
    msm_base = torch.arange(msms, device=dev)[:, None] * windows
    acc = sums[..., (msm_base + top).reshape(-1)]  # lane b G + j: run j of MSM b
    top_lanes = top.repeat(msms)
    for w in range(windows - 2, -1, -1):
        started = top_lanes > w
        for _ in range(c):
            acc = _sel_pt(started, dbl(acc), acc)
        j = max(i for i in range(runs) if lo[i] <= w)
        if w < int(top[j]):
            lane = torch.arange(msms, device=dev) * runs + j
            acc[..., lane] = add(acc[..., lane], sums[..., msm_base[:, 0] + w])
    acc = acc.reshape(acc.shape[:-1] + (msms, runs))
    out = acc[..., 0]
    for j in range(1, runs):
        out = add(out, acc[..., j])
    return out.contiguous()


# -- the fixed-base table (plain version of csrc/table.cu) ------------------


def to_affine_windows(jac: torch.Tensor) -> torch.Tensor:
    """[W, 3, L, N] Montgomery Jacobian -> [W, 2, L, N] Montgomery affine;
    a point at infinity gives (0, 0).

    Montgomery's batch trick along the window axis, as the kernel
    g1_fixedbase_table runs it in each lane: W - 1 prefix products of the
    Z's (a Z = 0 counts as one), one `FP.inv` per lane, and a backward
    pass that peels each Z_w^-1 off; then x = X Z^-2, y = Y Z^-3."""
    X, Y, Z = jac.unbind(1)
    inf = FP.is_zero(Z)  # [W, N]
    zs = lb.select(inf, FP.one_like(Z), Z)
    prefix = [zs[0]]
    for z in zs[1:]:
        prefix.append(FP.mul(prefix[-1], z))
    rest = FP.inv(prefix[-1])  # 1 / (Z_0 .. Z_w), from w = W - 1 down
    zinv = [None] * len(prefix)
    for w in range(len(prefix) - 1, 0, -1):
        zinv[w] = FP.mul(rest, prefix[w - 1])
        rest = FP.mul(rest, zs[w])
    zinv[0] = rest
    zinv = torch.stack(zinv)
    zinv2 = FP.sqr(zinv)
    aff = torch.stack([FP.mul(X, zinv2), FP.mul(Y, FP.mul(zinv2, zinv))], dim=1)
    return torch.where(inf[:, None, None, :], 0, aff)


def fixedbase_table(points: torch.Tensor, valid: torch.Tensor, c: int):
    """[2, L, N] Montgomery affine + valid[N] -> ([2, L, W N] affine table,
    valid[W N]); entry (w, i) = [2^(c w)] P_i at w N + i, and invalid
    source lanes stay invalid, and (0, 0), in every window."""
    w_count = num_windows(c)
    cur = lift(points, valid)
    shifted = []
    for w in range(w_count):
        shifted.append(cur)
        if w + 1 < w_count:
            for _ in range(c):
                cur = dbl(cur)
    aff = to_affine_windows(torch.stack(shifted))  # [W, 2, L, N]
    table = aff.permute(1, 2, 0, 3).reshape(2, L, -1)
    return table, valid.repeat(w_count)


# -- batched decompression, scalar multiplication, subgroup check -----------
# (plain versions of csrc/g1_batch.cu)


_BETA_MONT = G1_BETA * FP.R % FP.modulus


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """A radix-2^16 [L, 1] constant on like's device."""
    return lb.as_limb_tensor(lb.int_to_limbs(value, L), like.device)


def xy_from_x(x: torch.Tensor):
    """x [L, B] Montgomery -> (y0 = (x^3 + 4)^((p+1)/4) Montgomery [L, B],
    qr bool[B]: y0^2 == x^3 + 4, a square root existed). JAX `_xy_from_x`."""
    rhs = FP.add(FP.mul(FP.sqr(x), x), _const(B_G1_MONT, x))
    y0 = FP.pow_fixed(rhs, FP_SQRT_EXP)
    return y0, FP.eq(FP.sqr(y0), rhs)


def pick_sign(y0: torch.Tensor, want_largest: torch.Tensor) -> torch.Tensor:
    """y0 or p - y0, so that "y > (p-1)/2" matches want_largest bool[B]
    (the compressed sign bit). JAX `_pick_sign`: its compare_ge with the
    eq_half and zero fixups is y > (p-1)/2."""
    y = FP.from_mont(y0)
    _, le_half = FP._sub_borrow(_const(FP_HALF, y), y)  # (p-1)/2 >= y
    return lb.select(~le_half != want_largest, FP.neg(y0), y0)


def decompress_xy(x: torch.Tensor, want_largest: torch.Tensor):
    """x [L, B] Montgomery + want_largest bool[B] -> (y [L, B] Montgomery,
    qr bool[B]); the plain version of the kernel g1_decompress."""
    y0, qr = xy_from_x(x)
    return pick_sign(y0, want_largest), qr


def scalar_mul(points: torch.Tensor, scalars: torch.Tensor, nbits: int = 256) -> torch.Tensor:
    """[k_b] P_b: Jacobian [3, L, B] and plain scalars [16, B] (or [16, 1]
    for one scalar on every lane) -> [3, L, B], bits at or above nbits
    ignored. JAX `scalar_mul_per_lane` / `scalar_mul_fixed`: right to left,
    acc = add(acc, base) where the bit is set, then base = dbl(base),
    from acc at infinity. The loop ends at the highest set bit of any
    lane: acc does not change after it, so the limbs are JAX's."""
    shift = (nbits - 16 * torch.arange(16, device=scalars.device)).clamp(0, 16)[:, None]
    bits = scalars & ((1 << shift) - 1)
    live_limbs = torch.nonzero(bits.any(dim=-1))
    if live_limbs.numel() == 0:
        return torch.zeros_like(points)
    limb = int(live_limbs.max())
    top = 16 * limb + int(bits[limb].max()).bit_length()
    acc, base = torch.zeros_like(points), points
    for i in range(top):
        bit = ((bits[i // 16] >> (i % 16)) & 1).bool().expand(points.shape[-1])
        if bool(bit.any()):  # where no lane adds, acc stays as it is
            acc = _sel_pt(bit, add(acc, base), acc)
        if i + 1 < top:
            base = dbl(base)
    return acc


WINDOW = 4  # bits per window of window_mul
SPLIT_BITS = 128  # the width of each half of a split scalar


def _window_table(points: torch.Tensor) -> torch.Tensor:
    """[3, L, B] -> [2^WINDOW, 3, L, B]: T[0] = infinity, T[1] = P,
    T[2j] = dbl(T[j]), T[2j+1] = add(T[2j], P)."""
    table = [torch.zeros_like(points), points]
    for j in range(1, (1 << WINDOW) // 2):
        d = dbl(table[j])
        table += [d, add(d, points)]
    return torch.stack(table)


def window_mul(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """[k_b] P_b for SPLIT_BITS-bit scalars [8, B] (or [8, 1]) plain
    16-bit limbs, left to right in WINDOW-bit windows over
    `_window_table`: acc = T[top digit], then per window WINDOW doublings
    and acc = add(acc, T[digit]). The schedule of the kernel's split mode
    (`window_mul` in csrc/g1_batch.cu), so the limbs are the kernel's."""
    table = _window_table(points)
    n = points.shape[-1]
    per_limb = 16 // WINDOW

    def pick(w: int) -> torch.Tensor:
        d = (scalars[w // per_limb] >> (WINDOW * (w % per_limb))) & ((1 << WINDOW) - 1)
        idx = d.expand(n).reshape(1, 1, 1, n).expand(1, *table.shape[1:])
        return table.gather(0, idx)[0]

    windows = SPLIT_BITS // WINDOW
    acc = pick(windows - 1)
    for w in range(windows - 2, -1, -1):
        for _ in range(WINDOW):
            acc = dbl(acc)
        acc = add(acc, pick(w))
    return acc


def scalar_mul_endo(points: torch.Tensor, split: torch.Tensor) -> torch.Tensor:
    """[k1]P + [k2]sigma'(P), sigma'(P) = (BETA X, -Y, Z), for Jacobian
    [3, L, B] and split scalars [16, B] (or [16, 1]) plain 16-bit limbs,
    k1 in limbs 0-7 and k2 in limbs 8-15. For P in G1, sigma'(P) = [x^2]P,
    so this is [k1 + k2 x^2]P. The plain version of the kernel
    g1_scalar_mul's split mode: both halves through `window_mul` (here
    side by side on 2B lanes), then one add."""
    n = points.shape[-1]
    sigma = torch.stack([FP.mul(points[0], _const(_BETA_MONT, points)), FP.neg(points[1]),
                         points[2]])
    k = split.expand(16, n)
    both = window_mul(torch.cat([points, sigma], dim=-1), torch.cat([k[:8], k[8:]], dim=-1))
    return add(both[..., :n], both[..., n:])


def neg_y(p: torch.Tensor) -> torch.Tensor:
    """(X, -Y, Z): -P for Jacobian [3, L, B]; 0 stays 0."""
    return torch.stack([p[0], FP.neg(p[1]), p[2]], dim=0)


def fft_stage_endo(a: torch.Tensor, length: int, split: torch.Tensor) -> torch.Tensor:
    """One stage of length l of the setup conversion's G1 FFT, Jacobian
    [3, L, n] in natural order -> [3, L, n]: the n/2 butterflies, j-th with
    h = l/2 on even = a[e], e = (j / h) l + j % h, and odd = a[e + h], give
    even + t at e and even - t at e + h, t = `scalar_mul_endo`(odd, split
    [16, n/2] column j). The plain version of the kernel g1_fft_stage (JAX
    `g1_fft_device`'s loop body with the split twiddles)."""
    n = a.shape[-1]
    half = length // 2
    a4 = a.reshape(3, L, n // length, length)
    even = a4[..., :half].reshape(3, L, n // 2)
    odd = a4[..., half:].reshape(3, L, n // 2)
    t = scalar_mul_endo(odd, split)
    out_e = add(even, t).reshape(3, L, n // length, half)
    out_o = add(even, neg_y(t)).reshape(3, L, n // length, half)
    return torch.cat([out_e, out_o], dim=-1).reshape(3, L, n)


def jacobian_eq_mask(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bool[B]: p == q as curve points (cross-multiplied Jacobian test,
    JAX `_jacobian_eq_mask`)."""
    X1, Y1, Z1 = p.unbind(-3)
    X2, Y2, Z2 = q.unbind(-3)
    Z11, Z22 = FP.sqr(Z1), FP.sqr(Z2)
    ex = FP.eq(FP.mul(X1, Z22), FP.mul(X2, Z11))
    ey = FP.eq(FP.mul(FP.mul(Y1, Z2), Z22), FP.mul(FP.mul(Y2, Z1), Z11))
    inf1, inf2 = FP.is_zero(Z1), FP.is_zero(Z2)
    return torch.where(inf1 | inf2, inf1 == inf2, ex & ey)


def subgroup_mask(points: torch.Tensor) -> torch.Tensor:
    """bool[B]: P in G1 by Scott's endomorphism test, sigma(P) == -[x^2]P
    with sigma(X, Y, Z) = (BETA X, Y, Z); lanes at infinity pass. The
    plain version of the kernel g1_subgroup_mask (JAX `subgroup_mask`)."""
    x_abs = lb.as_limb_tensor(lb.int_to_limbs(-BLS_X, 16), points.device)
    xx = scalar_mul(scalar_mul(points, x_abs, 64), x_abs, 64)
    sigma = torch.stack([FP.mul(points[0], _const(_BETA_MONT, points)),
                         points[1], points[2]])
    neg_xx = torch.stack([xx[0], FP.neg(xx[1]), xx[2]])
    return jacobian_eq_mask(sigma, neg_xx)


# -- the op-namespace interface of ops/dispatch.py, identity layout ---------


def to_op_layout(x16: torch.Tensor) -> torch.Tensor:
    return x16


def from_op_layout(x: torch.Tensor) -> torch.Tensor:
    return x


def to_table_layout(table16: torch.Tensor) -> torch.Tensor:
    return table16


def from_table_layout(table: torch.Tensor) -> torch.Tensor:
    return table
