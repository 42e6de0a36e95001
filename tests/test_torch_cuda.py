"""The port's kernels against their plain versions on the card.

This module imports torch and the port, and nothing of JAX, so it
runs where the card is and JAX is not:

    python -m pytest --noconftest tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets up JAX.) Every test
is marked `cuda` and skips without a card: the kernels have no CPU mode.

- g1_madd, g1_add and g1_dbl on the 128 lanes of tests/test_torch_g1.py
  (random points of the mainnet Lagrange basis plus P at infinity,
  P == Q, P == -Q and dead lanes), limb for limb, Z included; g1_fold at
  K = 2, 3, 4 and 9 rows on 1, 12 and 200 lanes of the same points
  against g1_ops.fold; fp::sqr equals fp::mul(a, a) on random elements
  and on 0, 1, p - 1 and R mod p.

Basis: the first N points of the mainnet Lagrange basis, one of them at
infinity. For c in {3, 4, 6, 12}, g1_fixedbase_table's rows equal the
plain table (`g1_ops.fixedbase_table`) limb for limb, and
g1_bucket_accumulate over three seeded blobs (the last nearly all zero),
at chunks of 3 and 16 members, equals `g1_ops.accumulate_chunks`
limb for limb, and g1_bucket_reduce equals `g1_ops.reduce_chunks` on
those partials and on partials with points at infinity, equal and
opposite pairs inside a bucket's merge, and (one chunk a bucket) equal
and opposite bucket sums across the first fold. For c in {4, 8, 12},
g1_window_combine equals `g1_ops.combine_windows` on the window sums of
1 MSM (finite, Z != 1) and of 3 (`utils.combine_cases.combine_edge_sums`:
windows and runs at infinity, Horner, comb and last adds of equal and of
opposite points), also at small shapes of one to four runs, and the generic MSM of three MSMs
over the basis tiled twice runs one launch of each MSM kernel and the
combine and none of the table, equal to its plain version limb for limb
and to the host oracle.

On the mainnet setup: the quotient of a dense seeded blob, computed on
the card, equals the host quotient, and both MSM kernels equal their
plain versions on its members (dense 255-bit scalars fill every bucket,
the top window's too); one compute_blob_kzg_proof through
EIP4844Context(device="cuda") equals the host oracle g1_msm of the host
quotient, and verifies.

Batched G1 (csrc/g1_batch.cu), limb for limb against the plain versions
on the card: the cooperative field (fp_coop.cuh) against fp::mul, fp::sqr
and the plain sum and difference on 0, 1, p - 1, R mod p and random
elements; g1_decompress on setup x's, non-squares, 0 and p - 1 with
both signs; g1_scalar_mul on per-lane 255-bit scalars, 0, r, a truncated
nbits and one broadcast scalar, over lanes at infinity, Z != 1 and curve
points outside G1, and in its split mode (against
g1_ops.scalar_mul_endo, and on the lanes in G1 against the host [k]P);
g1_subgroup_mask on the same lanes, also against the host
g1_in_subgroup; g1_decompress, g1_scalar_mul (both modes) and
g1_subgroup_mask at 1, 12, 31, 33, 128 and 4096 lanes (the block and
warp edges of 4, 8 or 16 threads per lane); g1_fft_stage against
g1_ops.fft_stage_endo on 4096 points at stage lengths 2, 64 and 4096;
g1_fft_device at n = 16 in both directions, through g1_scalar_mul and
g1_add, and in the conversion's mode through g1_fft_stage, equal to the
plain versions' FFT; the generic MSM against the host g1_msm; and one
conversion of testdata/trusted_setup.txt, byte-equal to
cache/srs_mainnet.npz, with one g1_decompress, one g1_subgroup_mask, 12
g1_fft_stage, one g1_scalar_mul and no g1_add launches.

The Fr layer (csrc/fr_poly.cu on csrc/fr.cuh): fr_check's product,
square, sum, difference, negation, inverse and conversions equal the
plain FR on edge and random elements; fr_to_mont, fr_evaluate,
fr_quotient and fr_quotient_in_domain (m = 0, 1, n - 1 and a seeded m)
equal the plain versions at n = 4, 32 and 4096 and 1 to 64 blobs, one
launch each, the three polynomial kernels on the plain limbs and the
host's tables as FrDomain.open_mont and FrDomain.quotient_in_domain run
them (the quotient also before any evaluation; the tables unchanged after
them); fr_evaluate at z = w_m gives e_m; the in-domain wrapper refuses
an index outside [0, n); on the mainnet context a proof batch launches
fr_evaluate and fr_quotient once and no other Fr kernel, a proof at a root
of unity fr_quotient_in_domain once and no other (its MSM equal to the
host quotient's), a batch verification fr_evaluate once.

The multi-device tier on a logical (2, 2) mesh of the one card: a batch
of three blobs commits as the unsharded context does, in four launches
of each MSM kernel and two of g1_fold (one fold a row).

The pairing tier (csrc/pairing.cu): pairing_miller_loop equals
pairing_ops.miller_loop_jac and pairing_final_exp equals
pairing_ops.final_exp_check limb for limb, at B = 1 (a false check, and
a true one whose pair has a member at infinity), B = 2 (a true check)
and B = 5 (a false check with members at infinity), on Jacobian points
with Z != 1, and FE^3 equals the host pairing's value cubed; a true and
a false pairings_verify_host_points on the card launch each pairing
kernel once.

The C ABI (capi/): the port's library, loaded with ctypes, makes a
context on the card from a FILE * of the mainnet setup (one table
launch) and gives one commitment vector, one compute_kzg_proof vector
and one verify_blob_kzg_proof_batch vector of several blobs byte for
byte. EIP4844Context() with no arguments lands on the card, and its
warmup() launches the kernels of each entry point."""

import os
import random

import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu_torch import EIP4844Context, convert
from lambdaworks_kzg_tpu_torch.constants import P, R
from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
from lambdaworks_kzg_tpu_torch.host import field as HF
from lambdaworks_kzg_tpu_torch.host import pairing as HP
from lambdaworks_kzg_tpu_torch.host.field import fp_sqrt
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import (codec, dispatch, fp2_ops, fr_poly, g1_batch, g1_ops,
                                           kernels, limbs as lb, msm, pairing_ops, tower_ops)
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP, FR
from lambdaworks_kzg_tpu_torch.parallel import make_mesh
from lambdaworks_kzg_tpu_torch.utils import combine_cases, hashing as H

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card: the kernels have no CPU mode"),
]

N = 32
CHUNKS = (3, 16)  # members a chunk: many chunks a bucket, and few
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


@pytest.mark.parametrize("rows,lanes", [(2, 12), (3, 12), (4, 12), (4, 1), (9, 200)])
def test_fold_kernel_matches_plain_on_card(op_lanes, rows, lanes):
    """g1_fold against g1_ops.fold limb for limb, Z included, on K rows of
    the op lanes (P at infinity, P == Q, P == -Q among them, Z != 1), one
    launch, and the public limbs in and out."""
    p, _, _, q3 = op_lanes
    lanes_all = torch.cat([p, q3], dim=-1)
    pick = torch.arange(rows * lanes, device="cuda") % lanes_all.shape[-1]
    points = lanes_all[:, :, pick].reshape(3, 24, rows, lanes).permute(2, 0, 1, 3).contiguous()
    points[1, :, :, :1] = points[0, :, :, :1]  # the doubling on lane 0
    before = kernels.fold.launches
    got = kernels.fold(points)
    torch.cuda.synchronize()
    assert kernels.fold.launches == before + 1 and got.dtype == torch.int64
    assert torch.equal(got, g1_ops.fold(points))
    assert torch.equal(dispatch.fold(points), got)


def test_fp_coop_matches_fp_on_card():
    """The cooperative field of fp_coop.cuh: mul and sqr equal fp::mul and
    fp::sqr (and the plain product), add and sub the plain ones, is_zero
    and eq the host's."""
    rng = random.Random(23)
    edge = [0, 1, P - 1, (1 << 384) % P, P - 2, 2]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(P), rng.randrange(P)) for _ in range(290)]
    pairs += [(x, rng.randrange(P)) for x in edge] + [(rng.randrange(P), y) for y in edge]
    a16, b16 = (lb.as_limb_tensor(lb.ints_to_limbs(v, 24), "cuda") for v in zip(*pairs))
    before = kernels.coop_check.launches
    out = kernels.coop_check(lb.to_u32_layout(a16), lb.to_u32_layout(b16))
    torch.cuda.synchronize()
    assert kernels.coop_check.launches == before + 1
    assert torch.equal(out[0], out[4]) and torch.equal(out[1], out[5])
    assert torch.equal(lb.to_u16_layout(out[0]), FP.mul(a16, b16))
    assert torch.equal(lb.to_u16_layout(out[1]), FP.sqr(a16))
    assert torch.equal(lb.to_u16_layout(out[2]), FP.add(a16, b16))
    assert torch.equal(lb.to_u16_layout(out[3]), FP.sub(a16, b16))
    assert out[6, 0].tolist() == [int(x == 0) for x, _ in pairs]
    assert out[6, 1].tolist() == [int(x == y) for x, y in pairs]


def test_fp_sqr_equals_mul_on_card():
    rng = random.Random(5)
    values = [0, 1, P - 1, (1 << 384) % P] + [rng.randrange(P) for _ in range(252)]
    a = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs(values, 24), "cuda"))
    sq, mm = kernels.sqr_check(a)
    torch.cuda.synchronize()
    assert torch.equal(sq, mm)
    assert torch.equal(lb.to_u16_layout(sq), FP.sqr(lb.to_u16_layout(a)))


def test_fr_check_matches_plain_field_on_card():
    """fr.cuh's product, square, sum, difference, negation, inverse and both
    conversions equal the plain FR on 0, 1, r - 1, r - 2, 2, R mod r and
    random elements (200 lanes: a block and part of another)."""
    rng = random.Random(31)
    edge = [0, 1, R - 1, R - 2, 2, (1 << 256) % R]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(R), rng.randrange(R)) for _ in range(200 - len(pairs))]
    a16, b16 = (lb.as_limb_tensor(lb.ints_to_limbs(v, 16), "cuda") for v in zip(*pairs))
    before = kernels.fr_check.launches
    out = lb.to_u16_layout(kernels.fr_check(lb.to_u32_layout(a16), lb.to_u32_layout(b16)))
    torch.cuda.synchronize()
    assert kernels.fr_check.launches == before + 1
    want = (FR.mul(a16, b16), FR.sqr(a16), FR.add(a16, b16), FR.sub(a16, b16), FR.neg(a16),
            FR.inv(a16), FR.to_mont(a16), FR.from_mont(a16))
    for k, w in enumerate(want):
        assert torch.equal(out[k], w), k


@pytest.mark.parametrize("n,blobs", [(4, 1), (32, 3), (4096, 1), (4096, 6), (4096, 64)])
def test_fr_kernels_match_plain_on_card(n, blobs):
    """fr_to_mont, fr_evaluate, fr_quotient and fr_quotient_in_domain,
    through FrDomain on the card, equal the plain versions on the same
    tensors, one launch each: the in-domain index m runs over 0, 1, n - 1
    and a seeded m, on the plain limbs; open_mont (fr_evaluate and
    fr_quotient on the plain limbs) equals the plain versions' y out of
    Montgomery form and quotient. fr_quotient on a fresh table before any
    evaluation gives the same quotients, and no kernel changes the host's
    tables."""
    rng = random.Random(n + blobs)
    d = fr_poly.FrDomain(n, "cuda")
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs([rng.randrange(R) for _ in range(n)], 16)
                                        for _ in range(blobs)]), "cuda")
    zs = [rng.randrange(R) for _ in range(blobs)]
    z_m, zn1_m = d.z_consts(zs)
    watched = (kernels.fr_to_mont, kernels.fr_evaluate, kernels.fr_quotient,
               kernels.fr_quotient_in_domain)
    before = [k.launches for k in watched]
    evals_m = d.to_mont(plain)
    q_open, y_open = d.open_mont(plain, zs)
    ms = [(0, 1, n - 1, rng.randrange(n))[b % 4] for b in range(blobs)]
    onehot = torch.stack([torch.arange(n, device="cuda") == m for m in ms])
    z_inv = torch.stack([d.mont([pow(d.roots_brp_ints[m], R - 2, R)]) for m in ms])
    q_in = d.quotient_in_domain(plain, ms)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(watched, before)] == [1, 1, 1, 1]
    assert torch.equal(evals_m, FR.to_mont(plain))
    y_m = d.evaluate_mont_plain(evals_m, z_m, zn1_m)
    assert torch.equal(y_open, FR.from_mont(y_m))
    assert torch.equal(q_open, d.quotient_mont_plain(evals_m, y_m, z_m))
    assert torch.equal(q_in, d.quotient_in_domain_mont_plain(evals_m, onehot, z_inv))
    root_table = d.root_table(ms)
    assert torch.equal(kernels.fr_quotient_in_domain(plain, ms, root_table, d.roots_k), q_in)
    assert torch.equal(root_table.cpu(), torch.from_numpy(d.root_table_host(ms)))
    table = d.z_table(zs)
    assert torch.equal(kernels.fr_quotient(plain, y_open, table, d.roots_k), q_open)
    assert torch.equal(kernels.fr_evaluate(plain, table, d.roots_k, d.n_inv_k), y_open)
    assert torch.equal(table.cpu(), torch.from_numpy(d.z_table_host(zs)))
    for b in range(blobs):
        evals = lb.limbs_to_ints(plain[b])
        assert lb.limbs_to_ints(y_open[b]) == [fft.barycentric_evaluate(evals, zs[b], n)]
    roots_z = [d.roots_brp_ints[m] for m in ms]
    assert d.evaluate_blobs_plain(plain, roots_z) == [lb.limbs_to_ints(plain[b])[m]
                                                      for b, m in enumerate(ms)]


@pytest.mark.parametrize("n", [4, 32, 4096])
def test_fr_evaluate_at_a_root_gives_the_stored_element(n):
    """fr_evaluate runs no inversion: at z = w_m its numerator is n e_m, so
    y is the blob's stored element, at every m of a sample (all of them
    for n <= 32), also through FrDomain.evaluate."""
    rng = random.Random(3 * n)
    d = fr_poly.FrDomain(n, "cuda")
    ms = list(range(n)) if n <= 32 else [0, 1, 2, 2047, 2048, 4095] + rng.sample(range(n), 10)
    values = [[rng.randrange(R) for _ in range(n)] for _ in ms]
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(v, 16) for v in values]), "cuda")
    roots_z = [d.roots_brp_ints[m] for m in ms]
    y = kernels.fr_evaluate(plain, d.z_table(roots_z), d.roots_k, d.n_inv_k)
    assert lb.limbs_to_ints(y[..., 0].T) == [v[m] for v, m in zip(values, ms)]
    outside = rng.randrange(R)
    assert d.evaluate(values[0], outside) == fft.barycentric_evaluate(values[0], outside, n)


def test_fr_quotient_in_domain_rejects_a_bad_index():
    """The in-domain wrapper raises, before any launch, unless it gets one
    index in [0, n) per blob."""
    d = fr_poly.FrDomain(32, "cuda")
    evals = torch.zeros((2, 16, 32), dtype=torch.int64, device="cuda")
    table = d.root_table([0, 1])
    before = kernels.fr_quotient_in_domain.launches
    for bad in ([0, 32], [-1, 0], [0]):
        with pytest.raises(ValueError):
            kernels.fr_quotient_in_domain(evals, bad, table, d.roots_k)
    assert kernels.fr_quotient_in_domain.launches == before


def test_fr_domain_on_card_takes_the_kernels():
    """On the mainnet context: a proof batch makes one fr_evaluate and one
    fr_quotient launch and no fr_to_mont, a proof at a root of unity one
    fr_quotient_in_domain launch and no other and equals the host
    quotient's MSM, and a batch verification one fr_evaluate launch."""
    setup = srs.load_mainnet_setup()
    ctx = EIP4844Context(setup, backend=TorchBackend(setup, "cuda",
                                                     fixedbase=convert.fixedbase_from_npz(FIXEDBASE, "cpu")))
    watched = (kernels.fr_to_mont, kernels.fr_evaluate, kernels.fr_quotient,
               kernels.fr_quotient_in_domain)
    rng = random.Random(37)
    blobs = [_dense_blob(rng) for _ in range(3)]
    cs = ctx.blob_to_kzg_commitment_batch(blobs)
    before = [k.launches for k in watched]
    ps = ctx.compute_blob_kzg_proof_batch(blobs, cs)
    assert [k.launches - b for k, b in zip(watched, before)] == [0, 1, 1, 0]
    roots = ctx.backend.domain.roots_brp_ints
    before = [k.launches for k in watched]
    proof, y = ctx.compute_kzg_proof(blobs[0], roots[1].to_bytes(32, "little"))
    assert [k.launches - b for k, b in zip(watched, before)] == [0, 0, 0, 1]
    evals = [int.from_bytes(blobs[0][32 * i : 32 * i + 32], "little") for i in range(4096)]
    assert int.from_bytes(y, "little") == evals[1]
    # the quotient at z = w_1 in Python ints: (e_i - y) / (w_i - z) for i
    # != 1, and q_1 = sum_{i != 1} (e_i - y) w_i / (z (z - w_i))
    z = roots[1]
    q_host = [(e - evals[1]) * pow(w - z, R - 2, R) % R if i != 1 else 0
              for i, (e, w) in enumerate(zip(evals, roots))]
    q_host[1] = sum((e - evals[1]) * w * pow(z * (z - w), R - 2, R)
                    for i, (e, w) in enumerate(zip(evals, roots)) if i != 1) % R
    xs, ys = (FP.from_mont_host(setup.lagrange_points[k]) for k in range(2))
    basis = [(x, yy) if v else None for x, yy, v in zip(xs, ys, setup.lagrange_valid)]
    assert HC.compress_g1(HC.g1_msm(q_host, basis)) == proof
    before = [k.launches for k in watched]
    assert ctx.verify_blob_kzg_proof_batch(blobs, cs, ps) is True
    assert [k.launches - b for k, b in zip(watched, before)] == [0, 1, 0, 0]


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


def _special_partials(points, bstart, n_members, c, chunk, seed):
    """[3, 24, B K] chunk partials of Jacobian points with Z != 1 on every
    third slot; in buckets of several chunks, chunk 0 at infinity, or
    chunk 1 equal or opposite to chunk 0 (the merge doubles or cancels);
    of two one-chunk buckets j and j + 2^(c-1), the first at infinity, or
    the second equal or opposite to it (the fold's cases)."""
    first, _ = g1_ops.chunk_plan(bstart.cpu(), n_members, chunk)
    slots = g1_ops.chunk_slots(n_members, c, chunk)
    g = torch.Generator().manual_seed(seed)
    m = bstart.shape[0] * slots
    pts = points.cpu()[:, :, torch.randint(0, N, (m,), generator=g)]
    bk = g1_ops.lift(pts, torch.ones(m, dtype=torch.bool))
    bk = torch.where((torch.arange(m) % 3 == 0)[None, None], g1_ops.dbl(bk), bk)
    h = 1 << (c - 1)
    for b in range(bstart.shape[0]):
        f = [b * slots + int(x) for x in first[b]]
        for j in range(1, 1 << c):
            s0, n = f[j], f[j + 1] - f[j]
            if n == 1 and j < h and f[j + h + 1] - f[j + h] == 1:
                s0, s1 = s0, f[j + h]
            elif n >= 2:
                s1 = s0 + 1
            else:
                continue
            if j % 3 == 0:
                bk[:, :, s0] = 0
            else:
                bk[:, :, s1] = bk[:, :, s0]
                if j % 3 == 2:
                    bk[1, :, s1] = FP.neg(bk[1, :, s0 : s0 + 1])[:, 0]
    return bk.to(points.device)


@pytest.mark.parametrize("c", [3, 4, 6, 12])
def test_msm_kernels_match_plain_on_card(basis, c):
    points, valid = basis
    table, table_valid = msm.build_fixedbase_tables(points, valid, c)
    order, bstart = _members(table_valid, c, seed=20 + c)
    n_members = order.shape[1]
    for chunk in CHUNKS:
        want = g1_ops.accumulate_chunks(table, order, bstart, c, chunk)
        before = kernels.bucket_accumulate.launches
        got = kernels.bucket_accumulate(dispatch.to_table_layout(table), order, bstart, c, chunk)
        torch.cuda.synchronize()
        assert kernels.bucket_accumulate.launches == before + 1
        assert torch.equal(dispatch.from_table_layout(got), want), chunk
        for partials in (want, _special_partials(points, bstart, n_members, c, chunk, seed=c)):
            before = kernels.bucket_reduce.launches
            got = kernels.bucket_reduce(dispatch.to_table_layout(partials), bstart, c, chunk, n_members)
            torch.cuda.synchronize()
            assert kernels.bucket_reduce.launches == before + 1
            assert tuple(got.shape) == (3, 12, N_BLOBS)
            assert torch.equal(lb.to_u16_layout(got),
                               g1_ops.reduce_chunks(partials, bstart, c, chunk, n_members))


def _window_sums(points, c, msms, seed):
    """Window sums [3, 24, B W] (W = num_windows(c, 255)) of B = msms
    MSMs: at B = 1 from the basis, all finite, Z != 1 on every other lane;
    at B = 3 `combine_cases.combine_edge_sums` (windows and whole runs at
    infinity, Horner, comb and last adds of equal and of opposite
    points)."""
    w = msm.num_windows(c, 255)
    if msms == 3:
        return combine_cases.combine_edge_sums(c, w, seed, points.device), w
    g = torch.Generator().manual_seed(seed)
    pts = points.cpu()[:, :, torch.randint(4, N, (w,), generator=g)]  # past the dead lane 3
    jac = g1_ops.lift(pts, torch.ones(w, dtype=torch.bool))
    jac = torch.where((torch.arange(w) % 2 == 0)[None, None], g1_ops.dbl(jac), jac)
    return jac.to(points.device), w


@pytest.mark.parametrize("msms", [1, 3])
@pytest.mark.parametrize("c", [4, 8, 12])
def test_window_combine_kernel_matches_plain_on_card(basis, c, msms):
    points, _ = basis
    sums, w = _window_sums(points, c, msms, seed=c + msms)
    before = kernels.window_combine.launches
    got = kernels.window_combine(lb.to_u32_layout(sums), c, w)
    torch.cuda.synchronize()
    assert kernels.window_combine.launches == before + 1
    assert tuple(got.shape) == (3, 12, msms)
    want = g1_ops.combine_windows(sums, c, w)
    assert torch.equal(lb.to_u16_layout(got), want)
    assert torch.equal(dispatch.combine_windows(lb.to_u32_layout(sums), c, w), got)


@pytest.mark.parametrize("c,windows", [(3, 7), (4, 11), (8, 3), (12, 5), (3, 3), (4, 1)])
def test_window_combine_kernel_runs_match_plain_on_card(c, windows):
    """The kernel at small shapes (four runs, two, three of a window each,
    one window: `g1_ops.combine_runs`), on the edge sums of that schedule,
    equals the plain version limb for limb."""
    sums = combine_cases.combine_edge_sums(c, windows, seed=c + windows, device="cuda")
    got = kernels.window_combine(lb.to_u32_layout(sums), c, windows)
    assert torch.equal(lb.to_u16_layout(got), g1_ops.combine_windows(sums, c, windows))


@pytest.mark.parametrize("c,bits", [(4, 255), (8, 248), (12, 255)])
def test_generic_msm_kernels_match_plain_on_card(basis, c, bits):
    """msm_batch_device of three MSMs over the basis tiled twice (equal
    points), one of them all zero: the kernels (sort, accumulate, reduce,
    combine) equal the plain versions on the card limb for limb, one
    launch each, and the host oracle in affine form; no table."""
    points, valid = basis
    pts, ok = points.repeat(1, 1, 2), valid.repeat(2)
    rng = random.Random(c + bits)
    top = min(R, 1 << bits)
    ks = [[rng.randrange(top) for _ in range(2 * N)] for _ in range(2)] + [[0] * (2 * N)]
    scalars = torch.stack([msm.scalars_to_tensor(k, "cuda") for k in ks])
    used = (kernels.fixedbase_table, kernels.bucket_accumulate, kernels.bucket_reduce,
            kernels.window_combine)
    before = [k.launches for k in used]
    got = msm.msm_batch_device(pts, ok, scalars, c, bits)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(used, before)] == [0, 1, 1, 1]
    want = msm.msm_batch_device(pts, ok, scalars, c, bits, ops=g1_ops)
    assert torch.equal(lb.to_u16_layout(got), want)
    affine = [HC.to_affine(pt) for pt in g1_ops.points_to_host(g1_ops.lift(pts, ok))]
    for pt, k in zip(g1_ops.points_to_host(want), ks):
        assert HC.to_affine(pt) == HC.to_affine(HC.g1_msm(k, affine))


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
    q, y_dev = domain.open_mont(lb.as_limb_tensor(codec.blob_to_limbs(blob, 4096), "cuda")[None], [z])
    y, q_host = _host_quotient(blob, z)
    assert lb.limbs_to_ints(y_dev[0]) == [y]
    assert lb.limbs_to_ints(q[0]) == q_host
    digits = msm.fixedbase_digits(q, 8)
    assert int(msm.window_digits(q, 8)[0, -1].max()) > 0x40  # the top window is live
    order, bstart = msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), 8)
    n_members = order.shape[1]
    chunk = msm.chunk_length(1, n_members)
    got = kernels.bucket_accumulate(dispatch.to_table_layout(table16), order, bstart, 8, chunk)
    want = g1_ops.accumulate_chunks(table16, order, bstart, 8, chunk)
    torch.cuda.synchronize()
    assert torch.equal(dispatch.from_table_layout(got), want)
    reduced = kernels.bucket_reduce(got, bstart, 8, chunk, n_members)
    torch.cuda.synchronize()
    assert torch.equal(lb.to_u16_layout(reduced),
                       g1_ops.reduce_chunks(want, bstart, 8, chunk, n_members))


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


def _outside_g1(count: int):
    """Affine curve points outside G1, scanning x up from 2."""
    out, x = [], 2
    while len(out) < count:
        y = fp_sqrt((x * x % P * x + 4) % P)
        if y is not None and not HC.g1_in_subgroup((x, y, 1)):
            out.append((x, y))
        x += 1
    return out


@pytest.fixture(scope="module")
def batch_lanes():
    """[3, 24, 64] Jacobian lanes on the card: mainnet monomial points, every
    third doubled (Z != 1), lanes 5 and 17 at infinity, lanes 8..11 outside
    G1; and the host points they hold (None at infinity)."""
    setup = srs.load_mainnet_setup()
    pts = list(setup.g1_monomial[:64])
    pts[8:12] = _outside_g1(4)
    pts[5] = pts[17] = None
    aff, valid = g1_ops.make_points_host(pts)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, "cuda"), torch.from_numpy(valid).cuda())
    lane = torch.arange(64, device="cuda")
    jac = torch.where((lane % 3 == 1)[None, None], g1_ops.dbl(jac), jac).contiguous()
    host = [None if pt is None else HC.to_affine(HC.point_double(HC.from_affine(pt)))
            if i % 3 == 1 else pt for i, pt in enumerate(pts)]
    return jac, host


def test_decompress_kernel_matches_plain_on_card():
    setup = srs.load_mainnet_setup()
    xs = [pt[0] for pt in setup.g1_monomial[:56]]
    non_square = next(x for x in range(1, 100) if fp_sqrt((x * x * x + 4) % P) is None)
    xs += [0, P - 1, non_square, 1, 2, 3, P - 2, (1 << 380) % P]
    x16 = lb.as_limb_tensor(FP.to_mont_host(xs), "cuda")
    want = torch.arange(len(xs), device="cuda") % 2 == 0
    before = kernels.decompress.launches
    y, qr = kernels.decompress(lb.to_u32_layout(x16), want)
    torch.cuda.synchronize()
    assert kernels.decompress.launches == before + 1
    y_plain, qr_plain = g1_ops.decompress_xy(x16, want)
    assert torch.equal(lb.to_u16_layout(y), y_plain)
    assert torch.equal(qr, qr_plain)
    assert bool(qr[:56].all()) and not bool(qr[58])


def test_scalar_mul_kernel_matches_plain_on_card(batch_lanes):
    jac, host = batch_lanes
    rng = random.Random(17)
    ks = [rng.randrange(1 << 255) for _ in range(64)]
    ks[0], ks[1], ks[2], ks[3] = 0, R, R - 1, 1
    scalars = lb.as_limb_tensor(lb.ints_to_limbs(ks, 16), "cuda")
    for nbits in (256, 100):
        before = kernels.scalar_mul.launches
        got = kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(scalars), nbits)
        torch.cuda.synchronize()
        assert kernels.scalar_mul.launches == before + 1
        want = g1_ops.scalar_mul(jac, scalars, nbits)
        assert torch.equal(lb.to_u16_layout(got), want)
    for pt, aff, k in zip(g1_ops.points_to_host(lb.to_u16_layout(got)), host, ks):
        want_pt = HC.INFINITY if aff is None else HC.point_scalar_mul_raw(
            HC.from_affine(aff), k % (1 << 100))
        assert HC.points_eq(pt, want_pt)
    n_inv = pow(4096, R - 2, R)
    got = g1_batch.scalar_mul_fixed(jac, n_inv)
    assert torch.equal(got, g1_batch.scalar_mul_fixed(jac, n_inv, ops=g1_ops))


def test_scalar_mul_split_mode_matches_plain_on_card(batch_lanes):
    """The split mode (k1 + k2 x^2, words 0-3 and 4-7) against
    g1_ops.scalar_mul_endo limb for limb on every lane, outside G1 too, and
    against the host [k]P on the lanes in G1; per-lane and broadcast."""
    jac, host = batch_lanes
    rng = random.Random(29)
    ks = [rng.randrange(R) for _ in range(64)]
    ks[0], ks[1], ks[2], ks[3] = 0, 1, R - 1, g1_batch.X2
    split16 = lb.as_limb_tensor(g1_batch._split_limbs(ks), "cuda")
    before = kernels.scalar_mul.launches
    got = kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(split16), 128, split=True)
    torch.cuda.synchronize()
    assert kernels.scalar_mul.launches == before + 1
    assert torch.equal(lb.to_u16_layout(got), g1_ops.scalar_mul_endo(jac, split16))
    for i, (pt, aff, k) in enumerate(zip(g1_ops.points_to_host(lb.to_u16_layout(got)), host, ks)):
        if aff is None or HC.g1_in_subgroup(HC.from_affine(aff)):
            want = HC.INFINITY if aff is None else HC.point_scalar_mul_raw(HC.from_affine(aff), k)
            assert HC.points_eq(pt, want), i
    n_inv = g1_batch._split_limbs([pow(4096, R - 2, R)])
    got = g1_batch.scalar_mul_in_g1(jac, n_inv)
    assert torch.equal(got, g1_batch.scalar_mul_in_g1(jac, n_inv, ops=g1_ops))
    with pytest.raises(ValueError, match="128"):
        kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(split16), 256, split=True)


@pytest.mark.parametrize("lanes", [1, 12, 31, 33, 128, 4096])
def test_batch_kernels_at_block_and_warp_edges(lanes):
    """g1_decompress, g1_scalar_mul (both modes) and g1_subgroup_mask at
    lane counts that end inside a warp (8 lanes of 4 threads, 4 of 8, 2 of
    16) or a block of 64 threads, or fill them, on mainnet monomial points
    with Z != 1 on every third lane and every tenth at infinity (x = 0 for
    the decompression); 16-bit scalars in the general mode keep its plain
    version short."""
    setup = srs.load_mainnet_setup()
    pts = [None if i % 10 == 9 else setup.g1_monomial[i % 4096] for i in range(lanes)]
    aff, valid = g1_ops.make_points_host(pts)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, "cuda"), torch.from_numpy(valid).cuda())
    lane = torch.arange(lanes, device="cuda")
    jac = torch.where((lane % 3 == 1)[None, None], g1_ops.dbl(jac), jac).contiguous()
    rng = random.Random(lanes)
    x16 = lb.as_limb_tensor(FP.to_mont_host([0 if pt is None else pt[0] for pt in pts]), "cuda")
    want = torch.tensor([rng.random() < 0.5 for _ in pts], device="cuda")
    y, qr = kernels.decompress(lb.to_u32_layout(x16), want)
    y_plain, qr_plain = g1_ops.decompress_xy(x16, want)
    assert torch.equal(lb.to_u16_layout(y), y_plain) and torch.equal(qr, qr_plain)
    assert bool(qr.all())
    short = lb.as_limb_tensor(lb.ints_to_limbs([rng.randrange(1 << 16) for _ in pts], 16), "cuda")
    got = kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(short), 16)
    assert torch.equal(lb.to_u16_layout(got), g1_ops.scalar_mul(jac, short, 16))
    split16 = lb.as_limb_tensor(g1_batch._split_limbs([rng.randrange(R) for _ in pts]), "cuda")
    got = kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(split16), 128, split=True)
    assert torch.equal(lb.to_u16_layout(got), g1_ops.scalar_mul_endo(jac, split16))
    got = kernels.subgroup_mask(lb.to_u32_layout(jac))
    torch.cuda.synchronize()
    assert torch.equal(got, g1_ops.subgroup_mask(jac))
    assert bool(got.all())


def test_subgroup_mask_kernel_matches_plain_on_card(batch_lanes):
    jac, host = batch_lanes
    sums = g1_ops.add(jac, torch.roll(jac, 1, dims=-1))  # G1 + non-G1 sums too
    lanes = torch.cat([jac, sums], dim=-1).contiguous()
    before = kernels.subgroup_mask.launches
    got = kernels.subgroup_mask(lb.to_u32_layout(lanes))
    torch.cuda.synchronize()
    assert kernels.subgroup_mask.launches == before + 1
    assert torch.equal(got, g1_ops.subgroup_mask(lanes))
    assert got[:64].tolist() == [aff is None or HC.g1_in_subgroup(HC.from_affine(aff))
                                 for aff in host]
    assert not bool(got[8:12].any()) and bool(got[5]) and bool(got[17])
    assert got.tolist() == [HC.g1_in_subgroup(pt) for pt in g1_ops.points_to_host(lanes)]


@pytest.mark.parametrize("inverse", [True, False])
def test_fft_stages_match_plain_on_card(inverse):
    """g1_fft_device at n = 16 through g1_scalar_mul and g1_add equals the
    plain versions' FFT limb for limb, and the host FFT."""
    setup = srs.load_mainnet_setup()
    pts = setup.g1_monomial[:16]
    aff, valid = g1_ops.make_points_host(pts)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, "cuda"), torch.from_numpy(valid).cuda())
    before = (kernels.scalar_mul.launches, kernels.add.launches)
    got = g1_batch.g1_fft_device(jac, inverse=inverse)
    torch.cuda.synchronize()
    assert (kernels.scalar_mul.launches - before[0], kernels.add.launches - before[1]) == (
        4 + inverse, 8)
    assert torch.equal(got, g1_batch.g1_fft_device(jac, inverse=inverse, ops=g1_ops))
    want = fft.g1_fft([HC.from_affine(pt) for pt in pts], inverse=inverse)
    assert g1_batch.jacobians_to_host_affine(got) == [HC.to_affine(pt) for pt in want]


@pytest.mark.parametrize("length", [2, 64, 4096])
def test_fft_stage_kernel_matches_plain_on_card(length):
    """g1_fft_stage against g1_ops.fft_stage_endo on 4096 mainnet monomial
    points with the inverse FFT's twiddles of that stage: Z != 1 on every
    third lane, every 64th at infinity, and on every 16th butterfly whose
    twiddle is 1 odd == even, so t == even (the doubling, and infinity for
    even - t)."""
    setup = srs.load_mainnet_setup()
    n = 4096
    pts = [None if i % 64 == 5 else pt for i, pt in enumerate(setup.g1_monomial[:n])]
    aff, valid = g1_ops.make_points_host(pts)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, "cuda"), torch.from_numpy(valid).cuda())
    lane = torch.arange(n, device="cuda")
    jac = torch.where((lane % 3 == 1)[None, None], g1_ops.dbl(jac), jac).contiguous()
    half = length // 2
    for j in range(0, n // 2, 16 * half):  # j % half == 0: twiddle 1
        e = (j // half) * length
        jac[:, :, e + half] = jac[:, :, e]
    split16 = lb.as_limb_tensor(g1_batch._split_twiddles(n, True)[0][length.bit_length() - 2], "cuda")
    before = kernels.fft_stage.launches
    got = kernels.fft_stage(lb.to_u32_layout(jac), length, lb.to_u32_layout(split16))
    torch.cuda.synchronize()
    assert kernels.fft_stage.launches == before + 1
    want = g1_ops.fft_stage_endo(jac, length, split16)
    assert torch.equal(lb.to_u16_layout(got), want)
    assert not bool(want[2, :, half].any())  # even - t for t == even: infinity


@pytest.mark.parametrize("inverse", [True, False])
def test_fft_split_mode_stages_match_plain_on_card(inverse):
    """The conversion's FFT (in_g1: one g1_fft_stage per stage, [1/n] in
    g1_scalar_mul's split mode) at n = 16 equals the plain versions' split
    FFT limb for limb, and the host FFT."""
    setup = srs.load_mainnet_setup()
    pts = setup.g1_monomial[:16]
    aff, valid = g1_ops.make_points_host(pts)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, "cuda"), torch.from_numpy(valid).cuda())
    kernels_used = (kernels.scalar_mul, kernels.add, kernels.fft_stage)
    before = [k.launches for k in kernels_used]
    got = g1_batch.g1_fft_device(jac, inverse=inverse, in_g1=True)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels_used, before)] == [int(inverse), 0, 4]
    assert torch.equal(got, g1_batch.g1_fft_device(jac, inverse=inverse, ops=g1_ops, in_g1=True))
    want = fft.g1_fft([HC.from_affine(pt) for pt in pts], inverse=inverse)
    assert g1_batch.jacobians_to_host_affine(got) == [HC.to_affine(pt) for pt in want]


def test_generic_msm_matches_host_msm_on_card():
    setup = srs.load_mainnet_setup()
    pts = list(setup.g1_monomial[:65])
    pts[7] = None
    rng = random.Random(19)
    ks = [rng.randrange(R) for _ in pts]
    ks[0], ks[1] = 0, R - 1
    ctx_backend = EIP4844Context(setup, device="cuda").backend
    used = (kernels.fixedbase_table, kernels.bucket_accumulate, kernels.bucket_reduce,
            kernels.window_combine)
    before = [k.launches for k in used]
    got = ctx_backend.msm(ks, pts)
    assert [k.launches - b for k, b in zip(used, before)] == [0, 1, 1, 1]
    assert HC.to_affine(got) == HC.to_affine(HC.g1_msm(ks, pts))
    with pytest.raises(ValueError, match="2\\^248"):
        ctx_backend.msm([1 << 250], pts[2:3], scalar_bits=248)


def test_logical_mesh_commits_as_the_unsharded_context():
    """A (2, 2) mesh over cuda:0 four times, the mainnet table cut from
    the committed one: three blobs (padded to four over the data axis) give
    the unsharded context's commitments, in 2 x 2 launches of each MSM
    kernel and one g1_fold launch per row."""
    setup = srs.load_mainnet_setup()
    fixedbase = convert.fixedbase_from_npz(FIXEDBASE, "cpu")
    mesh = make_mesh(["cuda:0"] * 4, data=2, points=2)
    ctx = EIP4844Context(setup, backend=TorchBackend(setup, fixedbase=fixedbase, mesh=mesh))
    plain = EIP4844Context(setup, backend=TorchBackend(setup, "cuda", fixedbase=fixedbase))
    rng = random.Random(23)
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(4096))
             for _ in range(3)]
    used = (kernels.bucket_accumulate, kernels.bucket_reduce, kernels.fold)
    before = [k.launches for k in used]
    got = ctx.blob_to_kzg_commitment_batch(blobs)
    assert [k.launches - b for k, b in zip(used, before)] == [4, 4, 2]
    assert got == plain.blob_to_kzg_commitment_batch(blobs)


def test_mainnet_conversion_matches_cache(tmp_path):
    """testdata/trusted_setup.txt converted on the card, with no cache,
    equals cache/srs_mainnet.npz byte for byte."""
    import numpy as np

    kernels.reset_counts()
    setup = srs.load_trusted_setup_file(srs.MAINNET_SETUP_PATH, cache_dir=str(tmp_path),
                                        device="cuda")
    counts = {k.name: k.launches for k in kernels.ALL}
    assert counts["g1_decompress"] == 1 and counts["g1_subgroup_mask"] == 1
    assert counts["g1_fft_stage"] == 12 and counts["g1_scalar_mul"] == 1
    assert counts["g1_add"] == 0 and counts["g1_fold"] == 0
    assert counts["g1_dbl"] == 0 and counts["g1_madd"] == 0
    assert os.listdir(tmp_path) == ["srs_mainnet.npz"]
    with np.load(tmp_path / "srs_mainnet.npz") as got, np.load(
            os.path.join(os.path.dirname(FIXEDBASE), "srs_mainnet.npz")) as want:
        for key in ("lagrange", "monomial", "g2"):
            assert np.array_equal(got[key], want[key]), key
    ref = srs.load_mainnet_setup()
    assert np.array_equal(setup.lagrange_points, ref.lagrange_points)
    assert setup.g1_monomial == ref.g1_monomial and setup.g2_monomial == ref.g2_monomial


def _pairing_cases():
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    a, b = 13, 29
    pa, qb = HC.point_scalar_mul(G, a), HC.g2_scalar_mul(G2, b)
    pab = HC.point_scalar_mul(G, a * b)
    true_pairs = [(HC.point_neg(pab), G2), (pa, qb)]
    odd_pairs = [(HC.point_neg(pab), G2), (pa, HC.G2_INFINITY), (HC.point_scalar_mul(G, 5), qb),
                 ((1, 1, 0), G2), (pa, qb)]
    return {"true B=2": (true_pairs, True), "false B=5, members at infinity": (odd_pairs, False),
            "false B=1": ([(pa, qb)], False), "true B=1, member at infinity": ([(pa, HC.G2_INFINITY)], True)}


@pytest.mark.parametrize("case", ["true B=2", "false B=5, members at infinity", "false B=1",
                                  "true B=1, member at infinity"])
def test_pairing_kernels_match_plain_on_card(case):
    pairs, verdict = _pairing_cases()[case]
    ps, qs = pairing_ops.jacobian_lanes(pairs, "cuda", seed=len(pairs))
    before = (kernels.miller_loop.launches, kernels.final_exp.launches)
    f = kernels.miller_loop(lb.to_u32_layout(ps), lb.to_u32_layout(qs))
    fe, ok = kernels.final_exp(f)
    torch.cuda.synchronize()
    assert (kernels.miller_loop.launches, kernels.final_exp.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    f_plain = pairing_ops.miller_loop_jac(ps, qs)
    assert torch.equal(lb.to_u16_layout(f), f_plain)
    fe_plain, ok_plain = pairing_ops.final_exp_check(f_plain)
    assert torch.equal(lb.to_u16_layout(fe), fe_plain)
    assert ok.tolist() == ok_plain.tolist() == [verdict]
    host = HP.pairing_batch(pairs)
    want = HF.fp12_mul(HF.fp12_sqr(host), host)
    assert tower_ops.fp12_to_host(tower_ops.unflatten12(lb.to_u16_layout(fe))) == [want]


def test_pairings_verify_on_card_launches_each_kernel_once():
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pa, qb = HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29)
    for scalar, verdict in ((13 * 29, True), (13 * 29 + 1, False)):
        before = (kernels.miller_loop.launches, kernels.final_exp.launches)
        got = pairing_ops.pairings_verify_host_points(HC.point_scalar_mul(G, scalar), G2, pa, qb,
                                                      "cuda")
        assert got is verdict
        assert (kernels.miller_loop.launches, kernels.final_exp.launches) == (before[0] + 1,
                                                                              before[1] + 1)


def _first_vector(fn: str, accept):
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata",
                        "consensus", fn, "small")
    for name in sorted(os.listdir(root)):
        case = load_case(os.path.join(root, name, "data.yaml"))
        if accept(case):
            return case
    raise AssertionError(f"no {fn} vector fits")


def test_c_abi_on_card(monkeypatch):
    """The port's C library (capi/) on the card: the mainnet setup from a
    FILE *, then one commitment vector, one compute_kzg_proof vector and
    one verify_blob_kzg_proof_batch vector of several blobs, byte-equal,
    each call launching the kernels on the card."""
    import ctypes

    from lambdaworks_kzg_tpu_torch import capi

    monkeypatch.delenv("LWKZG_BACKEND", raising=False)  # the default: the card
    lib = ctypes.CDLL(capi.build()["library"])

    class Settings(ctypes.Structure):
        _fields_ = [("fs", ctypes.c_void_p), ("g1_values", ctypes.c_void_p),
                    ("g2_values", ctypes.c_void_p)]

    libc = ctypes.CDLL(None)
    libc.fopen.restype = ctypes.c_void_p
    fp = libc.fopen(srs.MAINNET_SETUP_PATH.encode(), b"r")
    s = Settings()
    before = kernels.fixedbase_table.launches
    assert lib.load_trusted_setup_file(ctypes.byref(s), ctypes.c_void_p(fp)) == 0
    libc.fclose(ctypes.c_void_p(fp))
    assert kernels.fixedbase_table.launches == before + 1
    try:
        commit = _first_vector("blob_to_kzg_commitment", lambda c: c["output"] is not None)
        out = ctypes.create_string_buffer(48)
        before = kernels.bucket_accumulate.launches
        assert lib.blob_to_kzg_commitment(out, commit["input"]["blob"], ctypes.byref(s)) == 0
        assert out.raw == commit["output"] and kernels.bucket_accumulate.launches == before + 1

        prove = _first_vector("compute_kzg_proof", lambda c: c["output"] is not None)
        proof, y = ctypes.create_string_buffer(48), ctypes.create_string_buffer(32)
        assert lib.compute_kzg_proof(proof, y, prove["input"]["blob"], prove["input"]["z"],
                                     ctypes.byref(s)) == 0
        assert [proof.raw, y.raw] == prove["output"]

        batch = _first_vector("verify_blob_kzg_proof_batch",
                              lambda c: c["output"] is True and len(c["input"]["blobs"]) >= 2)
        inp, ok = batch["input"], ctypes.c_bool(False)
        before = kernels.miller_loop.launches
        assert lib.verify_blob_kzg_proof_batch(
            ctypes.byref(ok), b"".join(inp["blobs"]), b"".join(inp["commitments"]),
            b"".join(inp["proofs"]), ctypes.c_size_t(len(inp["blobs"])), ctypes.byref(s)) == 0
        assert ok.value is True and kernels.miller_loop.launches == before + 1
    finally:
        lib.free_trusted_setup(ctypes.byref(s))


def test_warmup_on_card(monkeypatch):
    """EIP4844Context() with no arguments is the mainnet setup on the card;
    warmup() builds the kernels and runs the entry points there: the MSM
    kernels for its commitments and proofs, the pairing kernels for its
    verifications, the batched decompression for its batch of two."""
    monkeypatch.delenv("LWKZG_BACKEND", raising=False)
    monkeypatch.delenv("LWKZG_TRUSTED_SETUP", raising=False)
    ctx = EIP4844Context()
    assert ctx.backend.device.type == "cuda" and ctx.n == 4096
    watched = (kernels.bucket_accumulate, kernels.miller_loop, kernels.decompress)
    before = [k.launches for k in watched]
    ctx.warmup()
    # commitment, two proofs, the batch's one batch of generic MSMs; three checks; one batch
    assert [k.launches - b for k, b in zip(watched, before)] == [4, 3, 1]


def test_native_routing_on_a_cuda_context(monkeypatch):
    """On a card the single checks take the native tier (decompression,
    [y]G1, [z]G2, verify_blob_kzg_proof's evaluation) while the pairing
    stays on the pairing kernels; a batch verification keeps the card
    (g1_decompress, the generic MSM, the card's evaluation) and calls
    none of the tier's batch functions. With LWKZG_NATIVE=0 the verdicts
    are the same."""
    from lambdaworks_kzg_tpu_torch import native

    setup = srs.load_mainnet_setup()
    ctx = EIP4844Context(setup, backend=TorchBackend(setup, "cuda",
                                                     fixedbase=convert.fixedbase_from_npz(FIXEDBASE, "cpu")))
    calls = {}
    for name in ("g1_decompress", "g1_scalar_mul_affine", "g2_scalar_mul_affine", "blob_eval",
                 "g1_msm_affine", "pairings_verify_affine"):
        def spy(*args, _fn=getattr(native, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(native, name, spy)
    rng = random.Random(29)
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(4096)) for _ in range(2)]
    cs = ctx.blob_to_kzg_commitment_batch(blobs)
    ps = ctx.compute_blob_kzg_proof_batch(blobs, cs)
    calls.clear()
    before = [k.launches for k in (kernels.miller_loop, kernels.decompress)]
    assert ctx.verify_blob_kzg_proof(blobs[0], cs[0], ps[0]) is True
    assert calls == {"g1_decompress": 2, "g1_scalar_mul_affine": 1, "g2_scalar_mul_affine": 1,
                     "blob_eval": 1}
    calls.clear()
    assert ctx.verify_blob_kzg_proof_batch(blobs, cs, ps) is True
    assert calls == {}
    assert [k.launches - b for k, b in zip((kernels.miller_loop, kernels.decompress), before)] == [2, 1]
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    assert ctx.verify_blob_kzg_proof(blobs[0], cs[0], ps[0]) is True
    assert ctx.verify_blob_kzg_proof(blobs[0], cs[0], ps[1]) is False
    assert calls == {}


def test_world_size_one_on_nccl():
    """initialize() of a one-process group on the card picks nccl; a
    context on its global mesh commits as the unsharded context, its
    results crossing the group by one all_gather."""
    import socket

    from lambdaworks_kzg_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(f"localhost:{port}", 1, 0) is True
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = distributed.global_mesh()
        assert mesh.ranks == ((0,),) and mesh.lead == torch.device("cuda", 0)
        setup = srs.load_mainnet_setup()
        fixedbase = convert.fixedbase_from_npz(FIXEDBASE, "cpu")
        ctx = EIP4844Context(setup, backend=TorchBackend(setup, fixedbase=fixedbase, mesh=mesh))
        plain = EIP4844Context(setup, backend=TorchBackend(setup, "cuda", fixedbase=fixedbase))
        rng = random.Random(31)
        blobs = [b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(4096))
                 for _ in range(3)]
        assert ctx.blob_to_kzg_commitment_batch(blobs) == plain.blob_to_kzg_commitment_batch(blobs)
    finally:
        torch.distributed.destroy_process_group()


def test_time_chained_captures_a_cuda_graph():
    """time_chained captures its chain of kernel launches in one CUDA
    graph; a step that waits on the host cannot be captured and raises."""
    from lambdaworks_kzg_tpu_torch.utils import profiling

    stats = profiling.collect_kernel_stats(lanes=256, iters=8)
    assert len(stats) == 4 and all(0 < s.seconds < 1 for s in stats)
    x0 = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        profiling.time_chained(lambda v: v + float(v.sum().item()), x0, iters=2)
