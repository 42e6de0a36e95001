"""The port's kernels against their plain versions on the card.

This module imports torch and the port, and nothing of JAX, so it
runs where the card is and JAX is not:

    python -m pytest --noconftest tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets up JAX.) Every test
is marked `cuda` and skips without a card: the kernels have no CPU mode.

- g1_madd, g1_add and g1_dbl on the 128 lanes of tests/test_torch_g1.py
  (random points of the mainnet Lagrange basis plus P at infinity,
  P == Q, P == -Q and dead lanes), limb for limb, Z included; fp::sqr
  equals fp::mul(a, a) on random elements and on 0, 1, p - 1 and R mod p.

Basis: the first N points of the mainnet Lagrange basis, one of them at
infinity. For c in {3, 4, 6, 12}, g1_fixedbase_table's rows equal the
plain table (`g1_ops.fixedbase_table`) limb for limb, and
g1_bucket_accumulate over three seeded blobs (the last nearly all zero)
equals `g1_ops.bucket_accumulate` limb for limb, and g1_bucket_reduce
equals `g1_ops.bucket_reduce` on those buckets and on buckets with
points at infinity, equal pairs (the doubling branch) and opposite pairs
(a sum at infinity). At c = 12 the reduce keeps its points in global
memory instead of shared memory.

On the mainnet setup: the quotient of a dense seeded blob, computed on
the card, equals the host quotient, and both MSM kernels equal their
plain versions on its members (dense 255-bit scalars fill every bucket,
the top window's too); one compute_blob_kzg_proof through
EIP4844Context(device="cuda") equals the host oracle g1_msm of the host
quotient, and verifies."""

import os
import random

import pytest
import torch

from lambdaworks_kzg_tpu_torch import EIP4844Context, convert
from lambdaworks_kzg_tpu_torch.constants import P, R
from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import codec, dispatch, fr_poly, g1_ops, kernels, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP, FR
from lambdaworks_kzg_tpu_torch.utils import hashing as H

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card: the kernels have no CPU mode"),
]

N = 32
GROUPS = 4
FIXEDBASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cache",
                         "fixedbase_62bcf72bba2b37b8_c8.npz")
N_BLOBS = 3
M_OPS = 128


@pytest.fixture(scope="module")
def basis():
    setup = srs.load_mainnet_setup()
    points = lb.as_limb_tensor(setup.lagrange_points[:, :, :N], "cuda")
    valid = torch.from_numpy(setup.lagrange_valid[:N].copy()).cuda()
    valid[3] = False  # an infinity lane must stay dead in every window
    return points, valid


@pytest.fixture(scope="module")
def op_lanes():
    """(p [3, 24, M], q [2, 24, M], q_valid [M], q3 [3, 24, M]) on the card,
    the lanes of tests/test_torch_g1.py drawn from the first 64 points of
    the mainnet basis: P at infinity (i % 16 == 3), P == Q (7), P == -Q
    (11), dead lanes (13), and Z != 1 on even lanes through one dbl."""
    setup = srs.load_mainnet_setup()
    base = lb.as_limb_tensor(setup.lagrange_points[:, :, :64], "cuda")
    rng = random.Random(7)
    picks = [(rng.randrange(64), rng.randrange(64)) for _ in range(M_OPS)]
    pa = base[:, :, [a for a, _ in picks]]
    qa = base[:, :, [b for _, b in picks]]
    lane = torch.arange(M_OPS, device="cuda")
    p_valid = lane % 16 != 3
    pa = torch.where(p_valid[None, None], pa, 0)
    qa = torch.where((lane % 16 == 7)[None, None], pa, qa)
    qa = torch.where((lane % 16 == 11)[None, None], torch.stack([pa[0], FP.neg(pa[1])]), qa)
    q_valid = lane % 16 != 13
    p = g1_ops.lift(pa, p_valid)
    p = torch.where((lane % 2 == 0)[None, None], g1_ops.dbl(p), p)
    return p.contiguous(), qa.contiguous(), q_valid, g1_ops.lift(qa, q_valid)


@pytest.mark.parametrize("op", ["madd", "add", "dbl"])
def test_hopper_kernel_matches_plain_on_card(op_lanes, op):
    p, q, qv, q3 = op_lanes
    k_args = {
        "madd": (lb.to_u32_layout(p), lb.to_u32_layout(q), qv),
        "add": (lb.to_u32_layout(p), lb.to_u32_layout(q3)),
        "dbl": (lb.to_u32_layout(p),),
    }[op]
    plain_args = {"madd": (p, q, qv), "add": (p, q3), "dbl": (p,)}[op]
    before = getattr(kernels, op).launches
    got = lb.to_u16_layout(getattr(kernels, op)(*k_args))
    torch.cuda.synchronize()
    assert getattr(kernels, op).launches == before + 1
    assert torch.equal(got, getattr(g1_ops, op)(*plain_args))


def test_fp_sqr_equals_mul_on_card():
    rng = random.Random(5)
    values = [0, 1, P - 1, (1 << 384) % P] + [rng.randrange(P) for _ in range(252)]
    a = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs(values, 24), "cuda"))
    sq, mm = kernels.sqr_check(a)
    torch.cuda.synchronize()
    assert torch.equal(sq, mm)
    assert torch.equal(lb.to_u16_layout(sq), FP.sqr(lb.to_u16_layout(a)))


@pytest.mark.parametrize("c", [3, 4, 6, 12])
def test_fixedbase_table_kernel_matches_plain_on_card(basis, c):
    points, valid = basis
    before = kernels.fixedbase_table.launches
    rows = kernels.fixedbase_table(lb.to_u32_layout(points), valid, c)
    torch.cuda.synchronize()
    assert kernels.fixedbase_table.launches == before + 1
    assert tuple(rows.shape) == (msm.num_windows(c) * N, 2, 12)
    want, want_valid = msm.build_fixedbase_tables(points, valid, c, ops=g1_ops)
    assert torch.equal(dispatch.from_table_layout(rows), want)
    got_rows, got_valid = dispatch.fixedbase_table(points, valid, c)
    assert torch.equal(got_rows, rows)
    assert torch.equal(got_valid, want_valid)


def _members(table_valid, c, seed):
    """Sorted members of N_BLOBS seeded blobs; the last is zero but one."""
    rng = random.Random(seed)
    blobs = [[rng.randrange(R) for _ in range(N)] for _ in range(N_BLOBS)]
    blobs[-1] = [0] * N
    blobs[-1][5] = rng.randrange(R)
    scalars = torch.stack([msm.scalars_to_tensor(s, table_valid.device) for s in blobs])
    digits = msm.fixedbase_digits(scalars, c)
    return msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), c)


def _special_buckets(points, c, seed):
    """[3, 24, B G 2^c] Jacobian buckets: Z != 1 on every third lane, and
    per group one at infinity, one pair equal and one pair opposite
    across the first fold (lanes j and j + 2^(c-1))."""
    g = torch.Generator().manual_seed(seed)
    m = N_BLOBS * GROUPS << c
    pick = torch.randint(0, N, (m,), generator=g).to(points.device)
    bk = g1_ops.lift(points[:, :, pick], torch.ones(m, dtype=torch.bool, device=points.device))
    lane = torch.arange(m, device=points.device)
    bk = torch.where((lane % 3 == 0)[None, None], g1_ops.dbl(bk), bk)
    h = 1 << (c - 1)
    base = torch.arange(0, m, 1 << c, device=points.device)
    bk[:, :, base + 2] = 0
    bk[:, :, base + 1 + h] = bk[:, :, base + 1]
    opp = bk[:, :, base + 3]
    bk[:, :, base + 3 + h] = torch.stack([opp[0], FP.neg(opp[1]), opp[2]])
    return bk.contiguous()


@pytest.mark.parametrize("c", [3, 4, 6, 12])
def test_msm_kernels_match_plain_on_card(basis, c):
    points, valid = basis
    table, table_valid = msm.build_fixedbase_tables(points, valid, c)
    order, bstart = _members(table_valid, c, seed=20 + c)

    before = kernels.bucket_accumulate.launches
    got = kernels.bucket_accumulate(dispatch.to_table_layout(table), order, bstart, c, GROUPS)
    want = g1_ops.bucket_accumulate(table, order, bstart, c, GROUPS)
    torch.cuda.synchronize()
    assert kernels.bucket_accumulate.launches == before + 1
    assert torch.equal(lb.to_u16_layout(got), want)

    for buckets in (want, _special_buckets(points, c, seed=c)):
        before = kernels.bucket_reduce.launches
        got = kernels.bucket_reduce(lb.to_u32_layout(buckets), c, GROUPS)
        torch.cuda.synchronize()
        assert kernels.bucket_reduce.launches == before + 1
        assert tuple(got.shape) == (3, 12, N_BLOBS)
        assert torch.equal(lb.to_u16_layout(got), g1_ops.bucket_reduce(buckets, c, GROUPS))


def _dense_blob(rng, n=4096):
    return b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(n))


def _host_quotient(blob, z, n=4096):
    evals = [int.from_bytes(blob[32 * i : 32 * i + 32], "little") for i in range(n)]
    y = fft.barycentric_evaluate(evals, z, n)
    return y, fft.quotient(evals, z, y, n)


def test_msm_kernels_match_plain_on_a_real_quotient():
    table16, table_valid = convert.fixedbase_from_npz(FIXEDBASE, "cuda")
    rng = random.Random(11)
    blob, z = _dense_blob(rng), rng.randrange(R)
    domain = fr_poly.FrDomain(4096, "cuda")
    z_m, zn1_m = domain.z_consts([z])
    evals_m = FR.to_mont(lb.as_limb_tensor(codec.blob_to_limbs(blob, 4096), "cuda")[None])
    y_m = domain.evaluate_mont(evals_m, z_m, zn1_m)
    q = domain.quotient_mont(evals_m, y_m, z_m)
    y, q_host = _host_quotient(blob, z)
    assert FR.from_mont_host(y_m[0]) == [y]
    assert lb.limbs_to_ints(q[0]) == q_host
    digits = msm.fixedbase_digits(q, 8)
    assert int(msm.window_digits(q, 8)[0, -1].max()) > 0x40  # the top window is live
    order, bstart = msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), 8)
    got = kernels.bucket_accumulate(dispatch.to_table_layout(table16), order, bstart, 8, 8)
    want = g1_ops.bucket_accumulate(table16, order, bstart, 8, 8)
    torch.cuda.synchronize()
    assert torch.equal(lb.to_u16_layout(got), want)
    reduced = kernels.bucket_reduce(got, 8, 8)
    torch.cuda.synchronize()
    assert torch.equal(lb.to_u16_layout(reduced), g1_ops.bucket_reduce(want, 8, 8))


def test_compute_blob_kzg_proof_matches_host_msm():
    setup = srs.load_mainnet_setup()
    ctx = EIP4844Context(setup, device="cuda")
    blob = _dense_blob(random.Random(13))
    commitment = ctx.blob_to_kzg_commitment(blob)
    before = (kernels.bucket_accumulate.launches, kernels.bucket_reduce.launches)
    proof = ctx.compute_blob_kzg_proof(blob, commitment)
    assert (kernels.bucket_accumulate.launches, kernels.bucket_reduce.launches) == (
        before[0] + 1, before[1] + 1)
    _, q_host = _host_quotient(blob, H.compute_challenge(blob, commitment))
    xs, ys = (FP.from_mont_host(setup.lagrange_points[k]) for k in range(2))
    basis = [(x, y) if v else None for x, y, v in zip(xs, ys, setup.lagrange_valid)]
    assert HC.compress_g1(HC.g1_msm(q_host, basis)) == proof
    assert ctx.verify_blob_kzg_proof(blob, commitment, proof)
