"""The port's batched G1 (`ops/g1_batch.py`) on its plain versions, held
against the JAX package, on the CPU.

- `decompress_batch` equals the JAX host `decompress_g1` point by point
  on the dev setup's points, the infinity encoding, a missing
  compression bit, non-canonical infinities, x >= p, a non-square x,
  curve points outside G1 (found by scanning x) and the consensus
  vectors' `*_not_in_G1` / `*_not_on_curve` points, and zeroes every lane
  that is not a valid finite point;
- `subgroup_mask` equals the JAX host `g1_in_subgroup` and
  `subgroup_mask_definitional` ([r]P == infinity) on points in and
  outside G1, with Z != 1 and at infinity;
- `scalar_mul_per_lane` (full-width scalars, 0, r and r - 1, lanes at
  infinity and outside G1) and `scalar_mul_fixed` equal the JAX host
  scalar multiplication;
- `g1_fft_device` equals the JAX `host/fft.g1_fft` in both directions at
  n = 8, and the port's host `g1_fft` equals JAX's;
- the kernel wrappers refuse CPU tensors and shapes they do not take,
  and dispatch sends CPU tensors to the plain versions;
- `slow`: the same inputs limb for limb against the JAX jitted
  `g1_batch` functions (XLA compiles of 256-step loops).
The kernels are held against these plain versions on the card in
tests/test_torch_cuda.py. A plain 255-bit scalar multiplication costs a
few seconds of small torch ops here, so full-width scalars run once per
function and semantics are checked with short ones."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import P, R
from lambdaworks_kzg_tpu.host import curve as JHC
from lambdaworks_kzg_tpu.host import fft as JFFT
from lambdaworks_kzg_tpu.host.field import fp_sqrt
from lambdaworks_kzg_tpu.models import srs as JSRS
from lambdaworks_kzg_tpu.ops import g1_batch as JB
from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_batch, g1_ops, kernels, limbs as lb
from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

N = 8
VECTORS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata",
                       "consensus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dev_setup():
    return JSRS.create_dev_setup(N, secret=0xFACE)


def _outside_g1(count: int):
    """Affine curve points outside G1, scanning x up from 2."""
    out, x = [], 2
    while len(out) < count:
        y = fp_sqrt((x * x % P * x + 4) % P)
        if y is not None and not JHC.g1_in_subgroup((x, y, 1)):
            out.append((x, y))
        x += 1
    return out


def _compress(aff, largest=None):
    """Affine (x, y) -> 48 bytes; `largest` overrides the sign bit."""
    out = bytearray(aff[0].to_bytes(48, "big"))
    out[0] |= 0x80
    if (aff[1] > (P - 1) // 2) if largest is None else largest:
        out[0] |= 0x20
    return bytes(out)


def _lanes(points):
    """Host affine points (None at infinity) -> Jacobian [3, 24, B] with
    Z != 1 on every third lane, and the host Jacobians they hold."""
    aff, valid = g1_ops.make_points_host(points)
    jac = g1_batch.lift_affine(lb.as_limb_tensor(aff), torch.from_numpy(valid))
    lane = torch.arange(len(points))
    jac = torch.where((lane % 3 == 1)[None, None], g1_ops.dbl(jac), jac)
    return jac, g1_ops.points_to_host(jac)


def _host_mul(pt, k: int):
    """[k]pt in affine form by the JAX host law, k not reduced mod r."""
    if HC.is_infinity(pt):
        return None
    return JHC.to_affine(JHC.FP_OPS, JHC.point_scalar_mul_raw(JHC.FP_OPS, pt, k))


def _vector_points():
    """The compressed points of the consensus vectors that are not in G1
    or not on the curve."""
    out = []
    for fn, key in (("verify_kzg_proof", "commitment"), ("verify_kzg_proof", "proof")):
        for what in ("not_in_G1", "not_on_curve"):
            case = load_case(os.path.join(VECTORS, fn, "small", f"{fn}_case_{key}_{what}",
                                          "data.yaml"))
            out.append(case["input"][key])
    return out


def test_decompress_batch_matches_jax_host(dev_setup):
    non_square = next(x for x in range(1, 100) if fp_sqrt((x ** 3 + 4) % P) is None)
    outside = _outside_g1(2)
    compressed = [JHC.compress_g1(JHC.from_affine(JHC.FP_OPS, a)) for a in dev_setup.g1_lagrange_brp]
    compressed += [
        bytes([0xC0]) + bytes(47),  # infinity
        bytes([0x00]) + bytes(47),  # no compression bit
        bytes([0x40]) + bytes(47),  # infinity without the compression bit
        bytes([0xC0]) + b"\x01" + bytes(46),  # non-canonical infinity
        bytes([0xE0]) + bytes(47),  # infinity with the sign bit
        bytes([0x9F]) + b"\xff" * 47,  # x >= p
        P.to_bytes(48, "big")[:1] + P.to_bytes(48, "big")[1:],  # x = p, no flag
        bytes([0x80 | (P >> 376)]) + P.to_bytes(48, "big")[1:],  # x = p
        bytes([0x80]) + non_square.to_bytes(48, "big")[1:],  # no square root
        bytes([0x80]) + bytes(47),  # x = 0: on the curve, outside G1
        _compress(outside[0]), _compress(outside[1], largest=False),
        _compress(dev_setup.g1_lagrange_brp[0], largest=True),  # the other root
    ] + _vector_points()
    pts, is_inf, err = g1_batch.decompress_batch(compressed)
    assert tuple(pts.shape) == (2, 24, len(compressed))
    host = g1_ops.points_to_host(g1_batch.lift_affine(pts, torch.from_numpy(~is_inf)))
    for i, data in enumerate(compressed):
        try:
            want = JHC.decompress_g1(data, subgroup_check=True)
        except JHC.DeserializationError:
            assert err[i] and not is_inf[i], i
            assert not bool(pts[:, :, i].any()), i
            continue
        assert not err[i], i
        if JHC.is_infinity(JHC.FP_OPS, want):
            assert is_inf[i] and not bool(pts[:, :, i].any()), i
        else:
            assert not is_inf[i], i
            assert HC.to_affine(host[i]) == JHC.to_affine(JHC.FP_OPS, want), i
    assert err.sum() == len(compressed) - N - 1 - 1  # all bad but the other root
    # without the subgroup check the points outside G1 decompress
    _, _, err_no_check = g1_batch.decompress_batch(compressed[N + 10 : N + 12], subgroup_check=False)
    assert not err_no_check.any()


def test_subgroup_masks_match_jax_host(dev_setup):
    pts = list(dev_setup.g1_monomial[:4]) + _outside_g1(3) + [None]
    jac, host = _lanes(pts)
    want = [JHC.g1_in_subgroup(pt) for pt in host]
    assert want == [True] * 4 + [False] * 3 + [True]
    assert g1_batch.subgroup_mask(jac).tolist() == want
    assert g1_batch.subgroup_mask_definitional(jac).tolist() == want


def test_scalar_mul_per_lane_matches_jax_host(dev_setup):
    """Full-width scalars with 0, r and r - 1, a lane at infinity and one
    outside G1 (where [r]P is not infinity)."""
    pts = list(dev_setup.g1_monomial[:5]) + [None] + _outside_g1(1) + [dev_setup.g1_monomial[5]]
    jac, host = _lanes(pts)
    rng = random.Random(3)
    ks = [rng.randrange(R) for _ in pts]
    ks[0], ks[1], ks[2], ks[6] = 0, R, R - 1, R
    got = g1_batch.scalar_mul_per_lane(jac, lb.as_limb_tensor(lb.ints_to_limbs(ks, 16)))
    got_host = g1_ops.points_to_host(got)
    for i, (pt, k) in enumerate(zip(got_host, ks)):
        assert HC.to_affine(pt) == _host_mul(host[i], k), i
    assert not HC.is_infinity(got_host[6])  # [r]P outside G1


def test_scalar_mul_fixed_matches_jax_host(dev_setup):
    pts = list(dev_setup.g1_monomial[:3]) + [None] + _outside_g1(1)
    jac, host = _lanes(pts)
    for k in (0xDEADBEEF12345678, 1, 0):
        got = g1_batch.scalar_mul_fixed(jac, k)
        for i, pt in enumerate(g1_ops.points_to_host(got)):
            assert HC.to_affine(pt) == _host_mul(host[i], k), (k, i)
    with pytest.raises(ValueError):
        g1_batch.scalar_mul_fixed(jac, 1 << 256)
    # bits at or above nbits are not read
    scalars = lb.as_limb_tensor(lb.ints_to_limbs([(1 << 40) | 5], 16))
    assert torch.equal(g1_ops.scalar_mul(jac, scalars, 40), g1_batch.scalar_mul_fixed(jac, 5))


@pytest.mark.parametrize("inverse", [True, False])
def test_g1_fft_device_matches_jax_host(dev_setup, inverse):
    jacs = [JHC.from_affine(JHC.FP_OPS, a) for a in dev_setup.g1_monomial]
    want = JFFT.g1_fft(jacs, inverse=inverse)
    assert [HC.to_affine(p) for p in fft.g1_fft(jacs, inverse=inverse)] == [
        JHC.to_affine(JHC.FP_OPS, p) for p in want]
    aff, valid = g1_ops.make_points_host(dev_setup.g1_monomial)
    got = g1_batch.g1_fft_device(g1_batch.lift_affine(lb.as_limb_tensor(aff), torch.from_numpy(valid)),
                                 inverse=inverse)
    assert g1_batch.jacobians_to_host_affine(got) == [JHC.to_affine(JHC.FP_OPS, p) for p in want]
    if inverse:
        assert g1_batch.jacobians_to_host_affine(got) == JFFT.bit_reversal_permutation(
            dev_setup.g1_lagrange_brp)


def test_batch_kernel_wrappers_refuse_what_they_do_not_take(dev_setup):
    """CPU tensors go to the plain versions through dispatch and never
    reach a kernel; the wrappers refuse them, wrong shapes and nbits."""
    jac, _ = _lanes(list(dev_setup.g1_monomial[:4]))
    x = jac[0]
    want = torch.tensor([True, False, True, False])
    kernels.reset_counts()
    y, qr = dispatch.decompress_xy(x, want)
    assert (y.shape, qr.tolist()) == (x.shape, [True] * 4)
    jac32 = lb.to_u32_layout(jac)
    k8 = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs([3] * 4, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.decompress(lb.to_u32_layout(x), want)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.scalar_mul(jac32, k8, 256)
    with pytest.raises(ValueError, match="shape"):
        kernels.scalar_mul(jac32[:, :6].contiguous(), k8, 256)
    with pytest.raises(ValueError, match="nbits"):
        kernels.scalar_mul(jac32, k8[:, :1].contiguous(), 257)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.subgroup_mask(jac32)
    with pytest.raises(ValueError, match="shape"):
        kernels.subgroup_mask(jac32[:2].contiguous())
    assert [k.launches for k in kernels.ALL] == [0] * len(kernels.ALL)


@pytest.mark.slow  # XLA-on-CPU compiles of the JAX 256-step loops
def test_g1_batch_matches_jax_jitted(dev_setup):
    pts = list(dev_setup.g1_monomial[:4]) + _outside_g1(2) + [None, dev_setup.g1_monomial[4]]
    jac, _ = _lanes(pts)
    jac_j = jnp.asarray(jac.numpy().astype(np.uint32))
    rng = random.Random(7)
    ks = [rng.randrange(R) for _ in pts]
    ks[0] = 0
    got = g1_batch.scalar_mul_per_lane(jac, lb.as_limb_tensor(lb.ints_to_limbs(ks, 16)))
    want = JB.scalar_mul_per_lane(jac_j, jnp.asarray(lb.ints_to_limbs(ks, 16)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(g1_batch.subgroup_mask(jac).numpy(), np.asarray(JB.subgroup_mask(jac_j)))
    compressed = [JHC.compress_g1(JHC.from_affine(JHC.FP_OPS, a)) for a in dev_setup.g1_monomial]
    compressed += [bytes([0x80]) + bytes(47), bytes([0xC0]) + bytes(47)]
    mine, want_j = g1_batch.decompress_batch(compressed), JB.decompress_batch(compressed)
    assert np.array_equal(mine[0].numpy(), np.asarray(want_j[0]).astype(np.int64))
    assert np.array_equal(mine[1], np.asarray(want_j[1])) and np.array_equal(mine[2], want_j[2])
    aff, valid = g1_ops.make_points_host(dev_setup.g1_monomial)
    lifted = g1_batch.lift_affine(lb.as_limb_tensor(aff), torch.from_numpy(valid))
    got = g1_batch.g1_fft_device(lifted, inverse=True)
    want = JB.g1_fft_device(jnp.asarray(lifted.numpy().astype(np.uint32)), inverse=True)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
