"""The port's G1 madd/add/dbl against the JAX package's, limb for limb
(Z included), on the 128 lanes of tests/test_pallas_kernels.py:
random points plus P at infinity, P == Q, P == -Q and dead lanes.

- the plain PyTorch versions against `ops/g1_ops` (the XLA tier);
- `slow`: against the TPU kernels `pallas_g1` (v1) and `pallas_g1_v2`
  in interpret mode, the TPU kernels the Hopper kernels replace;
- `cuda`: the Hopper kernels against the plain versions on the card
  (skips without one)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.host import curve as HC
from lambdaworks_kzg_tpu.models import srs
from lambdaworks_kzg_tpu.ops import g1_ops as JG
from lambdaworks_kzg_tpu.ops.field_ops import FP as JFP
from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels, limbs as lb
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

M = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_lift(points, valid):
    l, m = points.shape[1], points.shape[2]
    one = jnp.broadcast_to(JFP.ONE_limbs, (l, m)).astype(jnp.uint32)
    z = jnp.where(jnp.asarray(valid)[None, :], one, 0)
    return jnp.stack([points[0], points[1], z], axis=0)


@pytest.fixture(scope="module")
def lanes():
    """(p [3,L,M], q [2,L,M], q_valid [M], q3 [3,L,M]) as numpy arrays."""
    setup = srs.create_dev_setup(64, secret=0xFA11)
    base = setup.g1_lagrange_brp
    rng = random.Random(7)
    p_aff, q_aff, q_valid = [], [], []
    for i in range(M):
        a = base[rng.randrange(64)]
        b = base[rng.randrange(64)]
        if i % 16 == 3:
            a = None  # P at infinity: madd lifts Q
        if i % 16 == 7 and a is not None:
            b = a  # P == Q: doubling lane
        if i % 16 == 11 and a is not None:
            b = (a[0], (-a[1]) % HC.P)  # P == -Q: to infinity
        q_valid.append(i % 16 != 13)  # dead lane: P passes through
        p_aff.append(a)
        q_aff.append(b)
    p2, p_valid = JG.make_points_host(p_aff)
    q2, _ = JG.make_points_host(q_aff)
    qv = jnp.asarray(np.asarray(q_valid))
    p = _jax_lift(p2, p_valid)
    # a Jacobian p with Z != 1 on most lanes (doubled points)
    p = jnp.where((jnp.arange(M) % 2 == 0)[None, None, :], JG.dbl(p), p)
    q3 = _jax_lift(q2, qv)
    return tuple(np.asarray(x) for x in (p, q2, qv, q3))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=bool if x.dtype == bool else np.int64))


def test_make_points_host_matches_jax():
    setup = srs.create_dev_setup(8, secret=0xBEEF)
    aff = list(setup.g1_lagrange_brp) + [None]
    got, got_valid = g1_ops.make_points_host(aff)
    want, want_valid = JG.make_points_host(aff)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got_valid, np.asarray(want_valid))
    pts = np.asarray(_jax_lift(want, want_valid))
    assert g1_ops.points_to_host(_t(pts)) == JG.points_to_host(pts)


@pytest.mark.parametrize("op", ["madd", "add", "dbl"])
def test_point_op_matches_jax_g1_ops(lanes, op):
    p, q, qv, q3 = lanes
    if op == "madd":
        got = g1_ops.madd(_t(p), _t(q), _t(qv))
        want = JG.madd(jnp.asarray(p), jnp.asarray(q), jnp.asarray(qv))
    elif op == "add":
        got = g1_ops.add(_t(p), _t(q3))
        want = JG.add(jnp.asarray(p), jnp.asarray(q3))
    else:
        got = g1_ops.dbl(_t(p))
        want = JG.dbl(jnp.asarray(p))
    assert tuple(got.shape) == (3, 24, M)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_madd_exceptional_lanes_against_host_oracle(lanes):
    p, q, qv, _ = lanes
    got = g1_ops.points_to_host(g1_ops.madd(_t(p), _t(q), _t(qv)))
    p_host = g1_ops.points_to_host(_t(p))
    qx, qy = (FP.from_mont_host(q[k]) for k in range(2))
    for i in range(M):
        want = p_host[i]
        if qv[i]:
            want = HC.point_add(HC.FP_OPS, p_host[i], (qx[i], qy[i], 1))
        assert HC.points_eq(HC.FP_OPS, got[i], want), i


@pytest.mark.slow  # Pallas interpret mode: minutes of limb arithmetic on the CPU
def test_point_ops_match_pallas_kernels_interpret(lanes):
    from lambdaworks_kzg_tpu.ops import pallas_g1, pallas_g1_v2

    p, q, qv, q3 = lanes
    jp, jq, jqv, jq3 = (jnp.asarray(x) for x in lanes)
    mine = {
        "madd": g1_ops.madd(_t(p), _t(q), _t(qv)).numpy(),
        "add": g1_ops.add(_t(p), _t(q3)).numpy(),
        "dbl": g1_ops.dbl(_t(p)).numpy(),
    }
    for k in (pallas_g1, pallas_g1_v2):
        got = {
            "madd": k.madd(jp, jq, jqv, interpret=True),
            "add": k.add(jp, jq3, interpret=True),
            "dbl": k.dbl(jp, interpret=True),
        }
        for name, arr in got.items():
            assert np.array_equal(mine[name], np.asarray(arr).astype(np.int64)), (k.__name__, name)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["madd", "add", "dbl"])
def test_hopper_kernel_matches_plain_on_card(lanes, op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    p, q, qv, q3 = (_t(x).cuda() for x in lanes)
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


def test_kernel_wrappers_refuse_cpu_tensors(lanes):
    p = lb.to_u32_layout(_t(lanes[0]))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dbl(p)
    assert kernels.dbl.launches == 0
