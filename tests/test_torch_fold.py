"""The mesh's fold of its partials (`g1_ops.fold`, `dispatch.fold`; the
g1_fold kernel of `csrc/g1_batch.cu` on the card), on the CPU.

- The plain fold of K rows of Jacobian points (K = 1 to 5, odd K
  included; 1 and 6 lanes; points at infinity, equal and opposite rows,
  Z != 1) equals the per-level fold written out with `g1_ops.add` limb
  for limb, and the host oracle (`host/curve.py`) in affine form.
- A Python rendering of the kernel's schedule (a column's team of pairs,
  each level's sums in their slots, the odd last row left in the input,
  idle pairs adding again and storing nothing) equals the plain fold at
  K = 2 to 9 and 17, on the launcher's team and on one pair.
- `dispatch.fold` of one row is that row, with no kernel; the wrapper
  refuses a shape or a K outside [2, MAX_FOLD_ROWS] before any launch.

The route's launch counts on a mesh are in tests/test_torch_parallel.py;
the kernel itself runs only on the card (tests/test_torch_cuda.py -k
fold, and chip_smoke.py phase 3). The `slow` test holds the plain fold
against JAX's `_tree_fold_points` (an XLA compile)."""

import random

import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu_torch.constants import P, R
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

MAX_TEAM = 8  # the pairs of one 64-thread block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(k: int, lanes: int, seed: int):
    """K rows of `lanes` Jacobian points [K, 3, 24, B] and the host points
    [k][b]: multiples of G with Z != 1 on every other one, row 0 at
    infinity on lane 0, row 1 equal to row 0 on lane 1 and its negation on
    the last lane (where K > 1 and the lanes are there)."""
    rng = random.Random(seed)
    pts = [[HC.point_scalar_mul(HC.G1_GENERATOR, rng.randrange(1, R)) for _ in range(lanes)]
           for _ in range(k)]
    if lanes > 1:
        pts[0][0] = HC.INFINITY
    if k > 1 and lanes > 2:
        pts[1][1] = pts[0][1]
        pts[1][-1] = HC.point_neg(pts[0][-1])
    host = []
    for row in pts:
        lifted = []
        for b, pt in enumerate(row):
            if b % 2 and not HC.is_infinity(pt):  # (X l^2, Y l^3, l Z)
                lam = rng.randrange(2, 1 << 64)
                x, y, z = pt
                pt = (x * lam * lam % P, y * pow(lam, 3, P) % P, z * lam % P)
            lifted.append(pt)
        host.append(lifted)
    arr = np.stack([np.stack([FP.to_mont_host([pt[c] for pt in row]) for c in range(3)]) for row in host])
    return lb.as_limb_tensor(arr), host


def _per_level_fold(points):
    """The per-level fold spelled out: a `g1_ops.add` of the first half of
    the rows to the second over all their lanes, laid side by side, the
    odd row appended for the next level."""
    b = points.shape[-1]
    while points.shape[0] > 1:
        half = points.shape[0] // 2

        def lanes(x):
            return x.permute(1, 2, 0, 3).reshape(3, 24, half * b)

        folded = g1_ops.add(lanes(points[:half]), lanes(points[half:2 * half]))
        folded = folded.reshape(3, 24, half, b).permute(2, 0, 1, 3)
        if points.shape[0] % 2:
            folded = torch.cat([folded, points[2 * half:]], dim=0)
        points = folded
    return points[0]


def _fold_team(k: int) -> int:
    """As the launcher's fold_team: the largest power of two up to K / 2,
    at most MAX_TEAM."""
    team = 1
    while 2 * team <= k // 2 and 2 * team <= MAX_TEAM:
        team *= 2
    return team


def render_fold(points, team: int):
    """g1_fold_kernel's schedule, column by column, on g1_ops.add: `team`
    pairs a column take the adds j = p, p + team, ... of each level; a sum
    goes to slot j, or at the last level (k = 2) to the output; rows below
    k - 1 are read from their slots after the first level, the last row
    from slot `last`, or from the input while it is still row K - 1."""
    k_rows, lanes = points.shape[0], points.shape[-1]
    out = torch.empty_like(points[0])
    for col in range(lanes):
        slots = [None] * (k_rows // 2)
        k, last, last_in, first = k_rows, k_rows - 1, True, True
        while k > 1:
            half = k // 2

            def row(r):
                at = last if r == k - 1 else r
                if first or (r == k - 1 and last_in):
                    return points[at, :, :, col:col + 1]
                return slots[at]

            for base in range(0, half, team):
                sums = []
                for p in range(team):
                    act = base + p < half
                    j = base + p if act else half - 1
                    sums.append((act, j, g1_ops.add(row(j), row(half + j))))
                for act, j, s in sums:  # the round's pairs run side by side
                    if act and k == 2:
                        out[:, :, col:col + 1] = s
                    elif act:
                        slots[j] = s
            if k % 2 == 0:
                last, last_in = half - 1, False
            k, first = half + k % 2, False
    return out


@pytest.mark.parametrize("lanes", [1, 6])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_plain_fold_matches_per_level_adds_and_host(k, lanes):
    points, host = _rows(k, lanes, seed=10 * k + lanes)
    got = g1_ops.fold(points)
    assert got.shape == (3, 24, lanes)
    assert torch.equal(got, _per_level_fold(points))
    for b, pt in enumerate(g1_ops.points_to_host(got)):
        want = HC.INFINITY
        for row in host:
            want = HC.point_add(want, row[b])
        assert HC.to_affine(pt) == HC.to_affine(want), b


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7, 8, 9, 17])
def test_kernel_schedule_equals_the_plain_fold(k):
    """The rendering on 6 lanes at the launcher's team and on one pair,
    which must give the same points limb for limb as g1_ops.fold."""
    points, _ = _rows(k, 6, seed=k)
    want = g1_ops.fold(points)
    assert _fold_team(k) == min(MAX_TEAM, 1 << ((k // 2).bit_length() - 1))
    for team in sorted({1, _fold_team(k)}):
        assert torch.equal(render_fold(points, team), want), team


def test_dispatch_fold_of_one_row_and_the_wrapper_checks(monkeypatch):
    """One row folds to itself without a kernel; the wrapper refuses a K
    outside [2, MAX_FOLD_ROWS], a wrong shape or dtype, or a CPU tensor,
    before any launch."""
    points, _ = _rows(1, 3, seed=5)

    def refuse(*args):
        raise AssertionError("a fold of one row reached the kernel")

    monkeypatch.setattr(kernels, "fold", refuse)
    assert torch.equal(dispatch.fold(points), points[0])
    monkeypatch.undo()
    before = kernels.fold.launches
    two, _ = _rows(2, 3, seed=6)
    for bad in (points, two[:1].expand(kernels.MAX_FOLD_ROWS + 1, 3, 24, 3).contiguous(), two[:, :2],
                two.to(torch.int32), two):
        with pytest.raises(ValueError):
            kernels.fold(bad)
    assert kernels.fold.launches == before


@pytest.mark.slow
def test_plain_fold_matches_jax_tree_fold():
    """g1_ops.fold against the JAX package's `_tree_fold_points` at K = 3
    on 6 lanes (an XLA compile of its add)."""
    import jax.numpy as jnp

    from lambdaworks_kzg_tpu.parallel.msm import _tree_fold_points

    points, _ = _rows(3, 6, seed=31)
    want = np.asarray(_tree_fold_points(jnp.asarray(points.numpy().astype(np.uint32))))
    assert np.array_equal(g1_ops.fold(points).numpy(), want)
