"""Pippenger MSM: fixed-base over the trusted setup's commitment basis,
and windowed over any points.

The port of the JAX package's `ops/msm.py`. Both MSMs sort each blob's
members by digit and run the same two kernels (plain versions
`g1_ops.accumulate_chunks` and `reduce_chunks`): each blob's sorted
members are cut into chunks of at most `chunk` members of one bucket,
one chunk a lane, and each bucket's chunk partials are merged pairwise
before the fold, so no digit pattern lengthens a lane's chain, where the
JAX package's schedule deals a bucket to G lane groups.

The fixed-base MSM (`build_fixedbase_tables`, `msm_fixedbase_device`; its
table build is `g1_ops.fixedbase_table`, the plain version of the table
kernel): the basis is fixed for the life of a setup, so each window's
shift [2^(c w)] P_i is precomputed once; the MSM then feeds all W N
(digit, shifted point) pairs of a blob into one 2^c-bucket grid and
needs no Horner combine over windows. A batch of blobs shares one sort,
one accumulation and one reduce.

The generic MSM (`msm_device`, `msm_batch_device`, `msm`; JAX
`msm_device` + `combine_windows_host`) builds no table. Window w of each
MSM is a blob of its own over the N points themselves: its members are
the N points, its digits window w's, its 2^c buckets window w's, and the
reduce gives its window sum S_w = sum_b b B_{w,b} (JAX `bucket_reduce`'s
[3, L, W]). `ops.combine_windows` then sums sum_w
2^(c w) S_w (one g1_window_combine launch on a card). B MSMs over one
point set take B W blobs in one sort, one accumulation, one reduce and
one combine. The result is the same group element as JAX's, so the two
compare in affine form. JAX's top-window alias split (the top window's
few buckets spread over free alias buckets) has its counterpart in the
chunks, which spread any bucket over lanes; its `parts` split (a cap on
the packed sort key of its TPU sort) has none, since `torch.sort` sorts
int32 digits of any count. A scalar at or above 2^scalar_bits raises
where JAX drops its high windows.

Every function takes `ops`, the point-op namespace: `ops/dispatch.py`
(the default: Hopper kernels for CUDA tensors, plain versions on the
CPU) or `ops/g1_ops.py` (the plain versions on any device). Point
tensors stay in `ops`' layout from the first op to the last.
"""

import torch

from ..constants import R, num_windows
from . import dispatch, g1_ops, limbs as lb

# the chunk lengths L `chunk_length` picks from (the accumulation kernel
# takes up to kernels.MAX_CHUNK)
MIN_CHUNK, MAX_PICKED_CHUNK = 8, 256


def chunk_length(n_blobs: int, n_members: int) -> int:
    """Members a chunk lane of the accumulation takes at most (L) for a
    batch: 8 up to 2^20 members in all (the commit path, where one
    thread's chain of L madds bounds the accumulation and the reduce's
    merge grows with the chunks), then doubling with the members, up to
    256, so that the chunks stay near 2^17 where the IMADs bound it."""
    chunk = MIN_CHUNK
    while chunk < MAX_PICKED_CHUNK and chunk << 17 < n_blobs * n_members:
        chunk *= 2
    return chunk


def window_digits(scalars: torch.Tensor, c: int, scalar_bits: int = 256) -> torch.Tensor:
    """[..., 16, N] plain Fr limbs (int64) -> digits [..., W, N] (int64),
    W = num_windows(c, scalar_bits), digit w = (scalar >> (c w)) &
    (2^c - 1); c <= 16. The fixed-base tables cover 256 bits, the generic
    MSM's windows its scalar bound."""
    if not 1 <= c <= 16:
        raise ValueError("window size must be in [1, 16]")
    padded = torch.cat([scalars, torch.zeros_like(scalars[..., :1, :])], dim=-2)
    # window w starts at bit c w: limb k = c w // 16, shift s = c w % 16;
    # with c <= 16 it lies inside limbs k and k + 1. All windows at once,
    # a few tensor ops instead of a few per window.
    start = torch.arange(num_windows(c, scalar_bits), device=scalars.device) * c
    k, s = start // 16, (start % 16)[:, None]
    word = padded.index_select(-2, k) | (padded.index_select(-2, k + 1) << 16)
    return (word >> s) & ((1 << c) - 1)


def fixedbase_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """[..., 16, N] -> flat digits [..., W N]; member (w, i) at w N + i,
    the layout of `build_fixedbase_tables`."""
    return window_digits(scalars, c).flatten(-2)


def build_fixedbase_tables(points: torch.Tensor, valid: torch.Tensor, c: int,
                           ops=dispatch):
    """[2, 24, N] Montgomery affine + valid[N] -> ([2, 24, W N] affine
    table, valid[W N]) in the public layout; entry (w, i) = [2^(c w)] P_i,
    and invalid source lanes stay invalid (and zero) in every window.
    ops=g1_ops runs the plain version on any device; `dispatch` runs the
    kernel g1_fixedbase_table on a CUDA device."""
    table, table_valid = ops.fixedbase_table(points, valid, c)
    return ops.from_table_layout(table), table_valid


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
                         scalars: torch.Tensor, c: int = 8, chunk: int | None = None,
                         ops=dispatch) -> torch.Tensor:
    """Fixed-base MSM of B blobs -> Jacobian points [3, *, B] in `ops`'
    layout (B = 1 for [16, N] scalars).

    table: the affine table in `ops`' table layout (`to_table_layout`);
    scalars: [B, 16, N] or [16, N] plain Fr limbs (int64) on the table's
    device. Each blob's members are sorted by digit; bucket j's run is cut
    into ceil(k_j / chunk) chunks (chunk: `chunk_length` of the batch when
    None), each summed on a lane of its own (`accumulate_chunks`). The reduce merges each bucket's chunk sums
    pairwise and folds the buckets: the window weights are in the table.
    Nothing is read back to the host."""
    if scalars.dim() == 2:
        scalars = scalars[None]
    return msm_fixedbase_digits(table, table_valid, fixedbase_digits(scalars, c), c, chunk, ops)


def msm_fixedbase_digits(table: torch.Tensor, table_valid: torch.Tensor, digits: torch.Tensor,
                         c: int = 8, chunk: int | None = None, ops=dispatch) -> torch.Tensor:
    """`msm_fixedbase_device` from each member's digit: digits [B, M] for
    a table of M members (one digit per table row, in the table's row
    order) -> Jacobian points [3, *, B] in `ops`' layout."""
    digits = torch.where(table_valid, digits, torch.zeros_like(digits))
    order, bstart = sort_members(digits, c)
    if chunk is None:
        chunk = chunk_length(*order.shape)
    partials = ops.accumulate_chunks(table, order, bstart, c, chunk)
    return ops.reduce_chunks(partials, bstart, c, chunk, order.shape[1])


def msm_fixedbase(table, table_valid, scalars, c: int = 8, chunk: int | None = None,
                  ops=dispatch):
    """Fixed-base MSM -> host Jacobian point (Python ints) for [16, N]
    scalars, or a list of B points for [B, 16, N], in one transfer."""
    pt = msm_fixedbase_device(table, table_valid, scalars, c, chunk, ops)
    points = g1_ops.points_to_host(ops.from_op_layout(pt))
    return points if scalars.dim() == 3 else points[0]


def scalars_to_tensor(scalar_ints, device="cpu") -> torch.Tensor:
    """Python ints (mod r) -> [16, N] plain Fr limbs, int64."""
    return lb.as_limb_tensor(
        lb.ints_to_limbs([s % R for s in scalar_ints], 16), device
    )


# -- the generic MSM ---------------------------------------------------------


def check_scalar_bits(scalars: torch.Tensor, scalar_bits: int) -> None:
    """ValueError unless every [..., 16, N] plain scalar is below
    2^scalar_bits."""
    if not 1 <= scalar_bits <= 256:
        raise ValueError(f"scalar_bits must be in [1, 256], got {scalar_bits}")
    shift = (scalar_bits - 16 * torch.arange(16, device=scalars.device)).clamp(0, 16)
    if bool((scalars >> shift[:, None]).any()):
        raise ValueError(f"a scalar is not below 2^{scalar_bits}")


def window_sums(points: torch.Tensor, valid: torch.Tensor, digits: torch.Tensor, c: int,
                chunk: int | None = None, ops=dispatch) -> torch.Tensor:
    """Window sums S_{b,w} = sum_i d_{b,w,i} P_i of B MSMs over one point
    set -> Jacobian [3, *, B W] in `ops`' layout, MSM b's window w at
    b W + w (JAX `bucket_reduce`'s [3, L, W] for each MSM).

    points: [2, 24, N] public affine Montgomery limbs with valid bool[N]
    (an invalid point takes digit 0: weight 0); digits: [B, W, N] window
    digits. Each (MSM, window) is a blob whose members are the N points:
    one sort of the B W digit rows, one accumulation over the points in
    the table layout, one reduce."""
    digits = torch.where(valid, digits, torch.zeros_like(digits)).flatten(0, -2)
    order, bstart = sort_members(digits, c)
    if chunk is None:
        chunk = chunk_length(*order.shape)
    partials = ops.accumulate_chunks(ops.to_table_layout(points), order, bstart, c, chunk)
    return ops.reduce_chunks(partials, bstart, c, chunk, order.shape[1])


def msm_batch_device(points: torch.Tensor, valid: torch.Tensor, scalars: torch.Tensor, c: int,
                     scalar_bits: int = 255, chunk: int | None = None,
                     ops=dispatch) -> torch.Tensor:
    """sum_i k_{b,i} P_i for B MSMs over one point set -> Jacobian
    [3, *, B] in `ops`' layout.

    points: [2, 24, N] public affine Montgomery limbs with valid bool[N]
    (an invalid point counts as infinity); scalars: [B, 16, N] plain Fr
    limbs, each below 2^scalar_bits. The B W = B num_windows(c,
    scalar_bits) window sums (`window_sums`), then the combine of
    each MSM's W sums (`ops.combine_windows`: one g1_window_combine launch
    on a CUDA device). Only the scalar check's verdict comes back to the
    host."""
    check_scalar_bits(scalars, scalar_bits)
    digits = window_digits(scalars, c, scalar_bits)
    sums = window_sums(points, valid, digits, c, chunk, ops)
    return ops.combine_windows(sums, c, digits.shape[-2])


def msm_device(points: torch.Tensor, valid: torch.Tensor, scalars: torch.Tensor, c: int,
               scalar_bits: int = 255, chunk: int | None = None, ops=dispatch) -> torch.Tensor:
    """sum_i k_i P_i for [16, N] scalars -> Jacobian [3, *, 1] in `ops`'
    layout (`msm_batch_device` at B = 1)."""
    return msm_batch_device(points, valid, scalars[None], c, scalar_bits, chunk, ops)


def msm(points, valid, scalars, c: int, scalar_bits: int = 255, chunk: int | None = None,
        ops=dispatch):
    """Generic MSM -> host Jacobian point (Python ints)."""
    pt = msm_device(points, valid, scalars, c, scalar_bits, chunk, ops)
    return g1_ops.points_to_host(ops.from_op_layout(pt))[0]
