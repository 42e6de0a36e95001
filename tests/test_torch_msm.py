"""The port's fixed-base MSM at N = 32, c in {3, 4, 6} (the shapes of
tests/test_msm_reduce.py), chunks of 3 members (the JAX schedule's
stages at groups = 4), with a zero scalar and a source lane at infinity.

- the table equals the exact per-window shifts [2^(c w)] P_i computed by
  the host oracle, and the MSM equals `host/curve.g1_msm` in affine form,
  for one blob and for a batch of three;
- the table's plain version (`g1_ops.fixedbase_table`, the plain version
  of the kernel g1_fixedbase_table) equals the host oracle at c in
  {3, 4, 6, 12} with every 7th lane invalid, and its window-axis batch
  affine step equals a per-lane `FP.inv` affine on lanes with Z = 0 and
  Z = 1; the table kernel's wrapper refuses what it does not take;
- the MSM's two stages as the JAX package schedules them
  (`g1_ops.bucket_accumulate`, `bucket_reduce`; the kernels run the
  chunked schedule of tests/test_torch_msm_chunks.py): the batched
  accumulation equals each blob's alone and a round loop of the JAX
  package's `g1_ops.madd` over the same members, limb for limb; the
  batched reduce equals each blob's alone and the host oracle, on buckets
  with infinities, equal pairs (the doubling branch) and opposite pairs;
- the generic MSM (`msm.msm`, JAX's windowed MSM: window sums, then
  their Horner combine; tests/test_torch_msm_windows.py holds its
  stages) equals the JAX host `g1_msm` in affine form at c in {4, 8}
  with points at infinity, zero scalars and r - 1, and
  `TorchBackend.msm` does at its own window; a scalar at or above
  2^scalar_bits raises;
- `slow`: the table and MSM equal the JAX package's
  `msm.build_fixedbase_tables` and `msm.msm_fixedbase` (about three
  minutes of XLA-on-CPU compile and run at these shapes, measured on this
  test's CPU), and the reduce equals JAX `_bucket_reduce_fold` +
  `_tree_sum_lanes` limb for limb (77 s of XLA compiles, one per shape).
The kernels themselves are held against these plain versions on the card
in tests/test_torch_cuda.py, which needs no JAX."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import R
from lambdaworks_kzg_tpu.host import curve as HC
from lambdaworks_kzg_tpu.models import srs
from lambdaworks_kzg_tpu.ops import g1_ops as JG, msm as JM
from lambdaworks_kzg_tpu_torch import convert
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

N = 32
GROUPS = 4
CHUNK = 3  # members a chunk lane of the port's MSM takes at most


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def basis():
    setup = srs.create_dev_setup(N, secret=0xFB)
    pts_aff = list(setup.g1_lagrange_brp)
    pts_aff[3] = None  # an infinity lane must stay dead in every window
    rng = random.Random(9)
    scalars = [rng.randrange(R) for _ in range(N)]
    scalars[0] = 0
    points, valid = JG.make_points_host(pts_aff)
    return pts_aff, scalars, np.asarray(points), np.asarray(valid)


@pytest.fixture(scope="module")
def port_tables(basis):
    _, _, points, valid = basis
    return {
        c: msm.build_fixedbase_tables(lb.as_limb_tensor(points), torch.from_numpy(valid.copy()), c)
        for c in (3, 4, 6)
    }


def _oracle_table(pts_aff, c):
    shifted = []
    for pt in pts_aff:
        cur, col = HC.from_affine(HC.FP_OPS, pt), []
        for _ in range(msm.num_windows(c)):
            col.append(HC.to_affine(HC.FP_OPS, cur))
            for _ in range(c):
                cur = HC.point_double(HC.FP_OPS, cur)
        shifted.append(col)
    flat = [shifted[i][w] for w in range(msm.num_windows(c)) for i in range(len(pts_aff))]
    return g1_ops.make_points_host(flat)


@pytest.mark.parametrize("c", [3, 4, 6])
def test_table_matches_host_oracle(basis, port_tables, c):
    pts_aff, _, _, valid = basis
    table, table_valid = port_tables[c]
    want, want_valid = _oracle_table(pts_aff, c)
    assert tuple(table.shape) == (2, 24, msm.num_windows(c) * N)
    assert np.array_equal(table.numpy(), want.astype(np.int64))
    assert np.array_equal(table_valid.numpy(), np.tile(valid, msm.num_windows(c)))


@pytest.mark.parametrize("c", [3, 4, 6])
def test_msm_fixedbase_matches_host_oracle(basis, port_tables, c):
    pts_aff, scalars, _, _ = basis
    table, table_valid = port_tables[c]
    got = msm.msm_fixedbase(table, table_valid, msm.scalars_to_tensor(scalars), c=c, chunk=CHUNK)
    assert HC.points_eq(HC.FP_OPS, got, HC.g1_msm(scalars, pts_aff))


def test_window_digits_match_jax():
    rng = np.random.default_rng(11)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)]
    for c in (3, 4, 6, 8):
        got = msm.window_digits(msm.scalars_to_tensor(scalars), c)
        want = JM.window_digits(JM.scalars_to_device(scalars), c)
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_all_zero_scalars_give_infinity(basis, port_tables):
    table, table_valid = port_tables[4]
    got = msm.msm_fixedbase(table, table_valid, msm.scalars_to_tensor([0] * N), c=4, chunk=CHUNK)
    assert HC.is_infinity(HC.FP_OPS, got)


@pytest.mark.slow  # XLA-on-CPU compile and run of the JAX fixed-base MSM: ~3 min
@pytest.mark.parametrize("c", [3, 4, 6])
def test_table_and_msm_match_jax(basis, port_tables, c):
    _, scalars, points, valid = basis
    table, table_valid = JM.build_fixedbase_tables(jnp.asarray(points), jnp.asarray(valid), c)
    mine, mine_valid = port_tables[c]
    assert np.array_equal(mine.numpy(), np.asarray(table).astype(np.int64))
    assert np.array_equal(mine_valid.numpy(), np.asarray(table_valid))
    want = JM.msm_fixedbase(table, table_valid, JM.scalars_to_device(scalars), c=c, groups=GROUPS)
    got = msm.msm_fixedbase(mine, mine_valid, msm.scalars_to_tensor(scalars), c=c, chunk=CHUNK)
    assert HC.to_affine(HC.FP_OPS, got) == HC.to_affine(HC.FP_OPS, want)


def _blob_scalars(n_blobs, seed):
    """n_blobs lists of N scalars; the last blob is all zero but one."""
    rng = random.Random(seed)
    blobs = [[rng.randrange(R) for _ in range(N)] for _ in range(n_blobs)]
    blobs[-1] = [0] * N
    blobs[-1][5] = rng.randrange(R)
    return blobs


def _members(table_valid, blobs, c):
    scalars = torch.stack([msm.scalars_to_tensor(s) for s in blobs])
    digits = msm.fixedbase_digits(scalars, c)
    return msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), c)


@pytest.mark.parametrize("c", [3, 4, 6])
def test_msm_fixedbase_batch_matches_host_oracle(basis, port_tables, c):
    pts_aff = basis[0]
    table, table_valid = port_tables[c]
    blobs = _blob_scalars(3, seed=c)
    scalars = torch.stack([msm.scalars_to_tensor(s) for s in blobs])
    got = msm.msm_fixedbase(table, table_valid, scalars, c=c, chunk=CHUNK)
    assert len(got) == 3
    for pt, s in zip(got, blobs):
        assert HC.points_eq(HC.FP_OPS, pt, HC.g1_msm(s, pts_aff))


@pytest.mark.parametrize("c", [3, 4, 6])
def test_bucket_accumulate_batch_equals_single_blobs(port_tables, c):
    table, table_valid = port_tables[c]
    order, bstart = _members(table_valid, _blob_scalars(3, seed=10 + c), c)
    got = g1_ops.bucket_accumulate(table, order, bstart, c, GROUPS)
    lanes = GROUPS << c
    assert tuple(got.shape) == (3, 24, 3 * lanes)
    for b in range(3):
        one = g1_ops.bucket_accumulate(table, order[b : b + 1], bstart[b : b + 1], c, GROUPS)
        assert torch.equal(got[..., b * lanes : (b + 1) * lanes], one)


def test_bucket_accumulate_matches_jax_madd_rounds(basis, port_tables):
    """One blob at c = 4: the JAX `g1_ops.madd` (jitted once, 64 lanes)
    over the same member indices, round by round."""
    c, nb = 4, 16
    table, table_valid = port_tables[c]
    order, bstart = _members(table_valid, [basis[1]], c)
    got = g1_ops.bucket_accumulate(table, order, bstart, c, GROUPS)

    n_members = table.shape[-1]
    o, bs = order[0].numpy().astype(np.int64), bstart[0].numpy().astype(np.int64)
    be = np.append(bs[1:], n_members)
    rows = table.numpy().astype(np.uint32)
    madd = jax.jit(JG.madd)
    want = JG.infinity_like((), GROUPS * nb)
    g = np.arange(GROUPS)[:, None]
    rounds = -(-int((be - bs)[1:].max()) // GROUPS)
    for t in range(rounds):
        idx = bs[None, :] + g + t * GROUPS
        live = (idx < be[None, :]) & (np.arange(nb) != 0)
        member = o[np.minimum(idx, n_members - 1)].reshape(-1)
        want = madd(want, jnp.asarray(rows[:, :, member]), jnp.asarray(live.reshape(-1)))
    assert rounds > 1
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _reduce_buckets(points, valid, c, n_blobs, seed):
    """[3, 24, B G 2^c] Jacobian buckets from the basis: Z != 1 on every
    third lane, a few at infinity, and per group one pair equal and one
    pair opposite across the first fold (lanes j and j + 2^(c-1))."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(valid)
    m = n_blobs * GROUPS << c
    pick = torch.from_numpy(rng.choice(live, m))
    pts = torch.from_numpy(points.astype(np.int64))[:, :, pick]
    bk = g1_ops.lift(pts, torch.ones(m, dtype=torch.bool))
    bk = torch.where((torch.arange(m) % 3 == 0)[None, None], g1_ops.dbl(bk), bk)
    h = 1 << (c - 1)
    for base in range(0, m, 1 << c):
        bk[:, :, base + 2] = 0
        bk[:, :, base + 1 + h] = bk[:, :, base + 1]
        neg = bk[:, :, base + 3].clone()
        neg[1] = FP.neg(neg[1][:, None])[:, 0]
        bk[:, :, base + 3 + h] = neg
    return bk


def _oracle_reduce(buckets, c):
    """Per blob: sum over groups and buckets j >= 1 of j * B_j (host ints)."""
    pts = g1_ops.points_to_host(buckets)
    nb, out = 1 << c, []
    for b in range(len(pts) // (GROUPS * nb)):
        acc = None
        for lane in range(b * GROUPS * nb, (b + 1) * GROUPS * nb):
            j = lane % nb
            if j and not HC.is_infinity(HC.FP_OPS, pts[lane]):
                term = HC.g1_msm([j], [HC.to_affine(HC.FP_OPS, pts[lane])])
                acc = term if acc is None else HC.point_add(HC.FP_OPS, acc, term)
        out.append(acc)
    return out


@pytest.mark.parametrize("c", [3, 4])
def test_bucket_reduce_batch_matches_host_oracle(basis, c):
    _, _, points, valid = basis
    buckets = _reduce_buckets(points, valid, c, n_blobs=2, seed=c)
    got = g1_ops.bucket_reduce(buckets, c, GROUPS)
    assert tuple(got.shape) == (3, 24, 2)
    lanes = GROUPS << c
    for b, want in enumerate(_oracle_reduce(buckets, c)):
        one = g1_ops.bucket_reduce(buckets[..., b * lanes : (b + 1) * lanes], c, GROUPS)
        assert torch.equal(got[..., b : b + 1], one)
        assert HC.points_eq(HC.FP_OPS, g1_ops.points_to_host(one)[0], want)


@pytest.mark.slow  # XLA-on-CPU compiles of the JAX fold reduce, one per shape: ~77 s
def test_bucket_reduce_matches_jax_fold_and_tree(basis):
    _, _, points, valid = basis
    c = 4
    buckets = _reduce_buckets(points, valid, c, n_blobs=2, seed=44)
    arr = JM._zero_bucket0(jnp.asarray(buckets.numpy().astype(np.uint32)), c)
    sums = JM._bucket_reduce_fold(arr, c)
    want = JM._tree_sum_lanes(sums.reshape(sums.shape[:-1] + (2, GROUPS)))
    got = g1_ops.bucket_reduce(buckets, c, GROUPS)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_msm_kernel_wrappers_refuse_what_they_do_not_take(port_tables):
    """CPU tensors route to the plain versions through dispatch and never
    reach a kernel; the wrappers refuse them, and a window or chunk length
    their kernels do not take."""
    table, table_valid = port_tables[4]
    order, bstart = _members(table_valid, _blob_scalars(1, seed=3), 4)
    n_members = order.shape[1]
    kernels.reset_counts()
    partials = dispatch.accumulate_chunks(table, order, bstart, 4, CHUNK)
    assert torch.equal(partials, g1_ops.accumulate_chunks(table, order, bstart, 4, CHUNK))
    assert torch.equal(dispatch.reduce_chunks(partials, bstart, 4, CHUNK, n_members),
                       g1_ops.reduce_chunks(partials, bstart, 4, CHUNK, n_members))
    rows = lb.to_u32_layout(table).permute(2, 0, 1).contiguous()
    part_rows = lb.to_u32_layout(partials).permute(2, 0, 1).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bucket_accumulate(rows, order, bstart, 4, CHUNK)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bucket_reduce(part_rows, bstart, 4, CHUNK, n_members)
    with pytest.raises(ValueError, match="window bits"):
        kernels.bucket_reduce(part_rows, bstart, 13, CHUNK, n_members)
    with pytest.raises(ValueError, match="chunk"):
        kernels.bucket_accumulate(rows, order, bstart, 4, 0)
    assert [k.launches for k in kernels.ALL] == [0] * len(kernels.ALL)


@pytest.mark.parametrize("c", [3, 4, 6, 12])
def test_plain_table_with_invalid_lanes_matches_host_oracle(c):
    """Every 7th source lane invalid, its coordinates left in place: the
    table must zero it in every window, as the kernel does."""
    setup = srs.create_dev_setup(N, secret=0xFB)
    pts_aff = list(setup.g1_lagrange_brp)
    points, _ = g1_ops.make_points_host(pts_aff)
    valid = np.arange(N) % 7 != 0
    points, valid = lb.as_limb_tensor(points), torch.from_numpy(valid)
    table, table_valid = dispatch.fixedbase_table(points, valid, c)  # the CPU route
    oracle_pts = [pt if ok else None for pt, ok in zip(pts_aff, valid.tolist())]
    want, want_valid = _oracle_table(oracle_pts, c)
    assert tuple(table.shape) == (2, 24, msm.num_windows(c) * N)
    assert np.array_equal(table.numpy(), want.astype(np.int64))
    assert np.array_equal(table_valid.numpy(), want_valid)


def test_window_batch_affine_matches_per_lane_inverse(basis):
    """Windows of Z = 1 (lifted), Z != 1 (doubled) and Z = 0 lanes, some of
    them with nonzero X, Y: one inversion per lane along the windows
    equals FP.inv of every entry (the reference's affine step)."""
    _, _, points, valid = basis
    pts = lb.as_limb_tensor(points)
    lane = torch.arange(N)
    w0 = g1_ops.lift(pts, torch.from_numpy(valid.copy()))  # Z = 1, lane 3 at infinity
    w1 = g1_ops.dbl(w0)
    w2 = g1_ops.dbl(w1)
    w2[2, :, lane % 4 == 1] = 0  # Z = 0 under nonzero X, Y
    w3 = torch.where((lane % 5 == 2)[None, None], 0, g1_ops.dbl(w2))
    jac = torch.stack([w0, w1, w2, w3])
    got = g1_ops.to_affine_windows(jac)
    assert tuple(got.shape) == (4, 2, 24, N)
    for w in range(4):
        X, Y, Z = jac[w]
        zinv = FP.inv(Z)
        zinv2 = FP.sqr(zinv)
        want = torch.stack([FP.mul(X, zinv2), FP.mul(Y, FP.mul(zinv2, zinv))])
        assert torch.equal(got[w], want), w
    assert bool((got[2][:, :, lane % 4 == 1] == 0).all())
    assert bool((got[:, :, :, 3] == 0).all())


def test_fixedbase_table_kernel_refuses_what_it_does_not_take(basis):
    """CPU tensors, a wrong shape and a window width the kernel does not
    take raise before any launch."""
    _, _, points, valid = basis
    pts = lb.to_u32_layout(lb.as_limb_tensor(points))
    ok = torch.from_numpy(valid.copy())
    kernels.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fixedbase_table(pts, ok, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.fixedbase_table(pts[:, :6].contiguous(), ok, 4)
    for c in (0, 13):
        with pytest.raises(ValueError, match="window bits"):
            kernels.fixedbase_table(pts, ok, c)
    assert [k.launches for k in kernels.ALL] == [0] * len(kernels.ALL)


def _generic_inputs(basis, count, seed):
    """`count` basis points with one at infinity, scalars with a zero and
    r - 1."""
    pts_aff = list(basis[0][:count])
    pts_aff[2] = None
    rng = random.Random(seed)
    scalars = [rng.randrange(R) for _ in pts_aff]
    scalars[0], scalars[1] = 0, R - 1
    return pts_aff, scalars


@pytest.mark.parametrize("c", [4, 8])
def test_generic_msm_matches_host_oracle(basis, c):
    pts_aff, scalars = _generic_inputs(basis, 6, seed=c)
    points, valid = g1_ops.make_points_host(pts_aff)
    got = msm.msm(lb.as_limb_tensor(points), torch.from_numpy(valid), msm.scalars_to_tensor(scalars),
                  c, chunk=CHUNK)
    assert HC.to_affine(HC.FP_OPS, got) == HC.to_affine(HC.FP_OPS, HC.g1_msm(scalars, pts_aff))


def test_backend_msm_matches_host_oracle_and_checks_scalar_bits(basis, port_tables, monkeypatch):
    """TorchBackend.msm on a dev setup's backend (window auto_window(7) =
    4), as batch verification calls it; the native tier is off, so that
    the plain generic MSM runs (tests/test_torch_native.py holds the
    native route)."""
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    _, _, points, valid = basis
    setup = convert.setup_from_numpy(points, valid)
    backend = TorchBackend(setup, "cpu", fixedbase=port_tables[4])
    pts_aff, scalars = _generic_inputs(basis, 7, seed=5)
    got = backend.msm(scalars, pts_aff)
    assert HC.to_affine(HC.FP_OPS, got) == HC.to_affine(HC.FP_OPS, HC.g1_msm(scalars, pts_aff))
    assert HC.is_infinity(HC.FP_OPS, backend.msm([], []))
    with pytest.raises(ValueError, match="2\\^248"):
        backend.msm([1 << 250], pts_aff[:1], scalar_bits=248)
    with pytest.raises(ValueError, match="counts"):
        backend.msm([1, 2], pts_aff[:1])
    msm.check_scalar_bits(msm.scalars_to_tensor([R - 1]), 255)
    with pytest.raises(ValueError, match="2\\^254"):
        msm.check_scalar_bits(msm.scalars_to_tensor([R - 1]), 254)


@pytest.mark.parametrize("scalar_bits", [255, 248])
def test_generic_msm_at_c12_on_tiled_points_matches_host_oracle(basis, scalar_bits):
    """The generic MSM's window at 2^20 points (c = 12: 22 or 21 window
    blobs of 4096 buckets, the reduce's global-scratch route on the card)
    at 64 points: the basis (one point at infinity) tiled twice, so equal
    points share buckets and the accumulation's doubling branch runs;
    scalars below 2^scalar_bits, with a zero. ~10 s each, most of it the
    plain combine's 252 doublings."""
    pts_aff = list(basis[0]) * 2
    rng = random.Random(scalar_bits)
    scalars = [rng.randrange(min(R, 1 << scalar_bits)) for _ in pts_aff]
    scalars[5] = 0
    points, valid = g1_ops.make_points_host(pts_aff)
    got = msm.msm(lb.as_limb_tensor(points), torch.from_numpy(valid), msm.scalars_to_tensor(scalars),
                  12, scalar_bits=scalar_bits)
    assert HC.to_affine(HC.FP_OPS, got) == HC.to_affine(HC.FP_OPS, HC.g1_msm(scalars, pts_aff))
