"""The port's MSM kernels against their plain versions on the card.

This module imports torch and the port, and nothing of JAX, so it
runs where the card is and JAX is not:

    python -m pytest --noconftest tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets up JAX.) Every test
is marked `cuda` and skips without a card: the kernels have no CPU mode.

Basis: the first N points of the mainnet Lagrange basis, one of them at
infinity; tables for c in {3, 4, 6, 12} built on the card. For each c,
g1_bucket_accumulate over three seeded blobs (the last nearly all zero)
equals `g1_ops.bucket_accumulate` limb for limb, and g1_bucket_reduce
equals `g1_ops.bucket_reduce` on those buckets and on buckets with
points at infinity, equal pairs (the doubling branch) and opposite pairs
(a sum at infinity). At c = 12 the reduce keeps its points in global
memory instead of shared memory."""

import random

import pytest
import torch

from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card: the kernels have no CPU mode"),
]

N = 32
GROUPS = 4
N_BLOBS = 3


@pytest.fixture(scope="module")
def basis():
    setup = srs.load_mainnet_setup()
    points = lb.as_limb_tensor(setup.lagrange_points[:, :, :N], "cuda")
    valid = torch.from_numpy(setup.lagrange_valid[:N].copy()).cuda()
    valid[3] = False  # an infinity lane must stay dead in every window
    return points, valid


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
