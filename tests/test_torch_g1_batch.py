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
  n = 8, and the port's host `g1_fft` equals JAX's; so does its
  conversion mode (`in_g1=True`, the endomorphism split, one
  `fft_stage_endo` per stage);
- `g1_ops.fft_stage_endo` (the plain version of the kernel g1_fft_stage)
  equals the composition it replaced in the conversion mode (the split
  scalar multiplication of the odd half, two adds, the negation and the
  concatenation) at stage lengths 2, 4 and 32 on 32 lanes of the dev
  setup, with a lane at infinity and butterflies whose t equals even;
- `split_scalar` gives k = k1 + k2 x^2 with k1 < x^2 and k2 < 2^128, and
  `scalar_mul_in_g1` (the plain schedule of the kernel's split mode:
  4-bit windows over each half) equals the JAX host [k]P on points of
  G1, Z != 1 and infinity, for 0, 1, r - 1 and seeded scalars;
- the kernel wrappers refuse CPU tensors, shapes and stage lengths they
  do not take, and dispatch sends CPU tensors to the plain versions;
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
    pts, is_inf, err = g1_batch.decompress_batch(compressed, device="cpu")
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
    _, _, err_no_check = g1_batch.decompress_batch(compressed[N + 10 : N + 12], subgroup_check=False,
                                                   device="cpu")
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


X2 = (-0xD201000000010000) ** 2


def test_split_scalar_identity():
    rng = random.Random(31)
    for k in [0, 1, X2 - 1, X2, X2 + 1, R - 1] + [rng.randrange(R) for _ in range(64)]:
        k1, k2 = g1_batch.split_scalar(k)
        assert k == k1 + k2 * X2 and 0 <= k1 < X2 and 0 <= k2 < 1 << 128, k
    assert g1_batch.X2 == X2 and X2.bit_length() == 128
    limbs = g1_batch._split_limbs([X2 + 5, 7])
    assert limbs.shape == (16, 2)
    assert lb.limbs_to_ints(limbs[:8]) == [5, 7] and lb.limbs_to_ints(limbs[8:]) == [1, 0]
    for bad in (-1, R):
        with pytest.raises(ValueError):
            g1_batch.split_scalar(bad)


def test_scalar_mul_in_g1_matches_jax_host(dev_setup):
    """The split schedule on points of G1 (Z != 1 on every third lane) and
    at infinity, per lane and with one scalar on every lane."""
    pts = list(dev_setup.g1_monomial[:5]) + [None]
    jac, host = _lanes(pts)
    rng = random.Random(37)
    ks = [0, 1, R - 1, rng.randrange(R), rng.randrange(R), rng.randrange(R)]
    got = g1_batch.scalar_mul_in_g1(jac, g1_batch._split_limbs(ks), ops=dispatch)
    for i, (pt, k) in enumerate(zip(g1_ops.points_to_host(got), ks)):
        assert HC.to_affine(pt) == _host_mul(host[i], k), i
    k = rng.randrange(R)
    got = g1_batch.scalar_mul_in_g1(jac, g1_batch._split_limbs([k]))
    for i, pt in enumerate(g1_ops.points_to_host(got)):
        assert HC.to_affine(pt) == _host_mul(host[i], k), i


@pytest.mark.parametrize("inverse", [True, False])
def test_g1_fft_device_conversion_mode_matches_jax_host(dev_setup, inverse):
    jacs = [JHC.from_affine(JHC.FP_OPS, a) for a in dev_setup.g1_monomial]
    want = JFFT.g1_fft(jacs, inverse=inverse)
    aff, valid = g1_ops.make_points_host(dev_setup.g1_monomial)
    got = g1_batch.g1_fft_device(g1_batch.lift_affine(lb.as_limb_tensor(aff), torch.from_numpy(valid)),
                                 inverse=inverse, in_g1=True)
    assert g1_batch.jacobians_to_host_affine(got) == [JHC.to_affine(JHC.FP_OPS, p) for p in want]


@pytest.mark.parametrize("length", [2, 4, 32])
def test_fft_stage_endo_equals_the_composition_it_replaces(dev_setup, length):
    """One stage of the inverse FFT of 32 lanes: lane 6 at infinity, Z != 1
    on every third lane, and at length 2 (twiddles all 1) odd == even on
    butterflies 1 and 9, so t == even (the doubling) and even - t is
    infinity."""
    n = 32
    pts = [dev_setup.g1_monomial[i % N] for i in range(n)]
    pts[6] = None
    jac, _ = _lanes(pts)
    if length == 2:
        for j in (1, 9):
            jac[:, :, 2 * j + 1] = jac[:, :, 2 * j]
    split = g1_batch._split_twiddles(n, True)[0][length.bit_length() - 2]
    half = length // 2
    a4 = jac.reshape(3, 24, n // length, length)
    even = a4[..., :half].reshape(3, 24, n // 2)
    odd = a4[..., half:].reshape(3, 24, n // 2)
    t = g1_batch.scalar_mul_in_g1(odd, split, ops=g1_ops)
    out_e = g1_ops.add(even, t).reshape(3, 24, n // length, half)
    out_o = g1_ops.add(even, g1_batch._neg_y(t)).reshape(3, 24, n // length, half)
    want = torch.cat([out_e, out_o], dim=-1).reshape(3, 24, n)
    got = g1_ops.fft_stage_endo(jac, length, lb.as_limb_tensor(split))
    assert torch.equal(got, want)
    if length == 2:
        host = g1_ops.points_to_host(got)
        for j in (1, 9):
            assert HC.is_infinity(host[2 * j + 1])
            assert HC.points_eq(host[2 * j], HC.point_double(g1_ops.points_to_host(jac)[2 * j]))


def test_fft_stage_wrapper_refuses_what_it_does_not_take(dev_setup):
    """kernels.fft_stage refuses CPU tensors, a length that is not a power
    of two, a stage length outside [2, n] or not a power of two, and
    points of the wrong shape, before any launch."""
    jac, _ = _lanes([dev_setup.g1_monomial[i % N] for i in range(16)])
    a32 = lb.to_u32_layout(jac)
    k8 = lb.to_u32_layout(lb.as_limb_tensor(g1_batch._split_twiddles(16, True)[0][1]))
    kernels.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fft_stage(a32, 4, k8)
    with pytest.raises(ValueError, match="FFT length"):
        kernels.fft_stage(a32[..., :12].contiguous(), 4, k8[:, :6].contiguous())
    for length in (0, 1, 3, 6, 32):
        with pytest.raises(ValueError, match="stage length"):
            kernels.fft_stage(a32, length, k8)
    with pytest.raises(ValueError, match="shape"):
        kernels.fft_stage(a32[:, :6].contiguous(), 4, k8)
    assert kernels.fft_stage.launches == 0
    assert [k.launches for k in kernels.ALL] == [0] * len(kernels.ALL)


def test_split_mode_wrapper_refuses_what_it_does_not_take(dev_setup):
    jac, _ = _lanes(list(dev_setup.g1_monomial[:4]))
    jac32 = lb.to_u32_layout(jac)
    k8 = lb.to_u32_layout(lb.as_limb_tensor(g1_batch._split_limbs([3] * 4)))
    kernels.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.scalar_mul(jac32, k8, 128, split=True)
    with pytest.raises(ValueError, match="128"):
        kernels.scalar_mul(jac32, k8, 256, split=True)
    with pytest.raises(ValueError, match="shape"):
        kernels.scalar_mul(jac32[:, :6].contiguous(), k8, 128, split=True)
    assert kernels.scalar_mul.launches == 0


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
    mine, want_j = g1_batch.decompress_batch(compressed, device="cpu"), JB.decompress_batch(compressed)
    assert np.array_equal(mine[0].numpy(), np.asarray(want_j[0]).astype(np.int64))
    assert np.array_equal(mine[1], np.asarray(want_j[1])) and np.array_equal(mine[2], want_j[2])
    aff, valid = g1_ops.make_points_host(dev_setup.g1_monomial)
    lifted = g1_batch.lift_affine(lb.as_limb_tensor(aff), torch.from_numpy(valid))
    got = g1_batch.g1_fft_device(lifted, inverse=True)
    want = JB.g1_fft_device(jnp.asarray(lifted.numpy().astype(np.uint32)), inverse=True)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
