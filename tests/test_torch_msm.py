"""The port's fixed-base MSM at N = 32, c in {3, 4, 6}, groups = 4 (the
shapes of tests/test_msm_reduce.py), with a zero scalar and a source
lane at infinity.

- the table equals the exact per-window shifts [2^(c w)] P_i computed by
  the host oracle, and the MSM equals `host/curve.g1_msm` in affine form;
- `slow`: both equal the JAX package's `msm.build_fixedbase_tables` and
  `msm.msm_fixedbase` (about three minutes of XLA-on-CPU compile and run
  at these shapes, measured on this test's CPU)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import R
from lambdaworks_kzg_tpu.host import curve as HC
from lambdaworks_kzg_tpu.models import srs
from lambdaworks_kzg_tpu.ops import g1_ops as JG, msm as JM
from lambdaworks_kzg_tpu_torch.ops import g1_ops, limbs as lb, msm

N = 32
GROUPS = 4


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
    got = msm.msm_fixedbase(table, table_valid, msm.scalars_to_tensor(scalars), c=c, groups=GROUPS)
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
    got = msm.msm_fixedbase(table, table_valid, msm.scalars_to_tensor([0] * N), c=4, groups=GROUPS)
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
    got = msm.msm_fixedbase(mine, mine_valid, msm.scalars_to_tensor(scalars), c=c, groups=GROUPS)
    assert HC.to_affine(HC.FP_OPS, got) == HC.to_affine(HC.FP_OPS, want)
