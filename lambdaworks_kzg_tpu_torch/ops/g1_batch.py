"""Batched G1 on the device: decompression, the subgroup check, scalar
multiplication and the G1 group FFT.

The port of the JAX package's `ops/g1_batch.py`, with its names. JAX
runs the Pallas `add` and `dbl` kernels from XLA `fori_loop`s, one
`pallas_call` per step; here each loop is one kernel launch
(`csrc/g1_batch.cu`): `g1_decompress` (the square root and sign choice of
`_xy_from_x` + `_pick_sign`), `g1_scalar_mul` (the double-and-add of
`scalar_mul_fixed` / `scalar_mul_per_lane`) and `g1_subgroup_mask`
(`subgroup_mask` with `_jacobian_eq_mask`). Their plain versions are
`g1_ops.decompress_xy` (over `xy_from_x`, `pick_sign`),
`g1_ops.scalar_mul` and `g1_ops.subgroup_mask` (over
`jacobian_eq_mask`).

The setup conversion's FFT (`g1_fft_device(..., in_g1=True)`) splits
each scalar through the G1 endomorphism, k = k1 + k2 x^2 with k1, k2
below 2^128 (`split_scalar`, cached per FFT length), and runs each stage
as one `g1_fft_stage` launch (`ops.fft_stage_endo`: the split mode's
[k1]P + [k2]sigma'(P), sigma'(P) = (BETA X, -Y, Z) = [x^2]P, on the odd
half, then the butterflies) and [1/n] in `g1_scalar_mul`'s split mode
(`ops.scalar_mul_endo`). That holds only for points in G1, which the
conversion has checked; every other call takes the general
double-and-add and the `add` of the butterflies, which give the FFT of
any curve points.

Every function takes `ops`, as `ops/msm.py` does: `ops/dispatch.py`
(the default: a CUDA tensor goes to the kernels, a CPU tensor to the
plain versions) or `ops/g1_ops.py` (the plain versions on any device).
Points are in the public layout, Jacobian [3, 24, B] radix-2^16 int64
Montgomery limbs (infinity is Z == 0), scalars [16, B] plain Fr limbs.
The flag and range parsing of compressed bytes stays on the host, in
numpy, as in JAX.
"""

import functools

import numpy as np
import torch

from ..constants import BLS_X, P, R, fr_root_of_unity
from ..host import curve as HC
from ..host import fft as HFFT
from . import dispatch, g1_ops, limbs as lb
from .field_ops import FP

L = FP.L
X2 = BLS_X * BLS_X  # x^2: sigma'(P) = [x^2]P on G1, 128 bits


def lift_affine(points_aff: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[2, L, B] affine Montgomery + valid bool[B] -> [3, L, B] Jacobian."""
    return g1_ops.lift(points_aff, valid)


def _scalar_tensor(ints, device) -> torch.Tensor:
    return lb.as_limb_tensor(lb.ints_to_limbs(ints, 16), device)


def scalar_mul_fixed(points_jac: torch.Tensor, k: int, ops=dispatch) -> torch.Tensor:
    """[k]P on every lane for one host scalar 0 <= k < 2^256."""
    if not 0 <= k < 1 << 256:
        raise ValueError("scalar must be in [0, 2^256)")
    return ops.scalar_mul(points_jac, _scalar_tensor([k], points_jac.device),
                          max(k.bit_length(), 1))


def scalar_mul_per_lane(points_jac: torch.Tensor, scalars_plain: torch.Tensor,
                        ops=dispatch) -> torch.Tensor:
    """[k_b]P_b with per-lane 256-bit scalars [16, B] plain limbs."""
    return ops.scalar_mul(points_jac, scalars_plain, 256)


def split_scalar(k: int) -> tuple:
    """k in [0, r) -> (k1, k2) with k = k1 + k2 x^2, k1 < x^2, k2 < 2^128."""
    if not 0 <= k < R:
        raise ValueError("scalar must be in [0, r)")
    k2, k1 = divmod(k, X2)
    return k1, k2


def _split_limbs(ks) -> np.ndarray:
    """Scalars below r -> [16, n] plain limbs, k1 in limbs 0-7, k2 in 8-15."""
    halves = [split_scalar(k) for k in ks]
    return np.concatenate([lb.ints_to_limbs([h[0] for h in halves], 8),
                           lb.ints_to_limbs([h[1] for h in halves], 8)])


def scalar_mul_in_g1(points_jac: torch.Tensor, split_limbs, ops=dispatch) -> torch.Tensor:
    """[k_b]P_b for points of G1 only, through the endomorphism split:
    split_limbs [16, B] or [16, 1] numpy limbs as `_split_limbs` gives
    them."""
    return ops.scalar_mul_endo(points_jac, lb.as_limb_tensor(split_limbs, points_jac.device))


def subgroup_mask_definitional(points_jac: torch.Tensor, ops=dispatch) -> torch.Tensor:
    """bool[B]: [r]P == infinity, the definition the fast check is held
    against."""
    return FP.is_zero(scalar_mul_fixed(points_jac, R, ops)[2])


def subgroup_mask(points_jac: torch.Tensor, ops=dispatch) -> torch.Tensor:
    """bool[B]: P in G1 (sigma(P) == -[x^2]P); lanes at infinity pass."""
    return ops.subgroup_mask(points_jac)


def decompress_batch(compressed, subgroup_check: bool = True, device="cuda", ops=dispatch):
    """Batched G1 decompression of n 48-byte strings on `device` (the
    card unless "cpu" is asked for; raises where CUDA is absent).

    Returns (points_aff [2, L, n] Montgomery on `device`, infinity
    bool[n], error bool[n]), the flags as numpy. Three control bits, the
    sign picks the lexicographically larger y, then the subgroup check.
    Error lanes (no compression bit, a bad infinity, x >= p, no square
    root, outside G1) and lanes at infinity are zero in points_aff."""
    device = dispatch.resolve_device(device)
    n = len(compressed)
    arr = np.frombuffer(b"".join(compressed), dtype=np.uint8).reshape(n, 48)
    c_bit = (arr[:, 0] >> 7) & 1
    i_bit = (arr[:, 0] >> 6) & 1
    s_bit = (arr[:, 0] >> 5) & 1
    masked = arr.copy()
    masked[:, 0] &= 0x1F
    x_ints = [int.from_bytes(masked[i].tobytes(), "big") for i in range(n)]

    error = c_bit == 0  # the uncompressed form is not taken
    is_inf = (i_bit == 1) & ~error
    canonical_inf = is_inf & (s_bit == 0) & np.asarray([v == 0 for v in x_ints], dtype=bool)
    error |= is_inf & ~canonical_inf
    error |= np.asarray([v >= P for v in x_ints], dtype=bool) & ~is_inf

    # junk x on error lanes, masked below
    x_mont = lb.as_limb_tensor(FP.to_mont_host([v % P for v in x_ints]), device)
    y, qr = ops.decompress_xy(x_mont, torch.from_numpy(s_bit == 1).to(device))
    error |= ~qr.cpu().numpy() & ~is_inf  # x is not on the curve
    valid = ~error & ~is_inf

    points_aff = torch.stack([x_mont, y], dim=0)
    if subgroup_check:
        jac = lift_affine(points_aff, torch.from_numpy(valid).to(device))
        in_sub = ops.subgroup_mask(jac).cpu().numpy()
        error |= ~in_sub & valid
        valid &= in_sub
    keep = torch.from_numpy(valid).to(device)
    points_aff = torch.where(keep[None, None, :], points_aff, 0)
    return points_aff, is_inf & ~error, error


_neg_y = g1_ops.neg_y


@functools.lru_cache(maxsize=8)
def _twiddles(n: int, inverse: bool) -> tuple:
    """Per stage of the length-n FFT, the twiddle of each odd lane (a
    stage of length l repeats w^0 .. w^(l/2 - 1) n/l times), and 1/n."""
    stages, length = [], 2
    while length <= n:
        w = fr_root_of_unity(length)
        if inverse:
            w = pow(w, R - 2, R)
        tw = [1] * (length // 2)
        for j in range(1, length // 2):
            tw[j] = tw[j - 1] * w % R
        stages.append(tw * (n // length))
        length *= 2
    return tuple(stages), pow(n, R - 2, R)


@functools.lru_cache(maxsize=8)
def _split_twiddles(n: int, inverse: bool) -> tuple:
    """`_twiddles` split through the endomorphism: [16, n/2] limbs per
    stage and [16, 1] for 1/n (numpy)."""
    stages, n_inv = _twiddles(n, inverse)
    return tuple(_split_limbs(tw) for tw in stages), _split_limbs([n_inv])


def g1_fft_device(points_jac: torch.Tensor, inverse: bool = False, ops=dispatch,
                  in_g1: bool = False) -> torch.Tensor:
    """Radix-2 FFT over G1, [3, L, n] -> [3, L, n], natural order in and
    out (as host/fft.g1_fft). Per stage of n/2 butterflies: one per-lane
    scalar multiplication of the odd half by its twiddles, a negation of
    its Y, and two batched adds; the inverse ends with [1/n] on every
    lane. in_g1: every point is in G1 (the caller has checked), so each
    stage is one `ops.fft_stage_endo` in the op layout (the scalars split
    through the endomorphism) and [1/n] the split mode; on a point outside
    G1 that gives another result."""
    n = points_jac.shape[-1]
    if n & (n - 1):
        raise ValueError("the FFT length must be a power of two")
    dev = points_jac.device
    brp = torch.tensor(HFFT.bit_reversal_permutation(list(range(n))), device=dev)
    stages, n_inv = _twiddles(n, inverse)
    if in_g1:
        split = _split_twiddles(n, inverse)
        a = ops.to_op_layout(points_jac).index_select(-1, brp)
        for s in range(len(stages)):
            a = ops.fft_stage_endo(a, 2 << s, lb.as_limb_tensor(split[0][s], dev))
        a = ops.from_op_layout(a)
        return scalar_mul_in_g1(a, split[1], ops) if inverse else a
    a = points_jac.index_select(-1, brp)
    length = 2
    for tw in stages:
        half = length // 2
        a4 = a.reshape(3, L, n // length, length)
        even = a4[..., :half].reshape(3, L, n // 2)
        odd = a4[..., half:].reshape(3, L, n // 2)
        t = scalar_mul_per_lane(odd, _scalar_tensor(tw, dev), ops)
        out_e = ops.add(even, t).reshape(3, L, n // length, half)
        out_o = ops.add(even, _neg_y(t)).reshape(3, L, n // length, half)
        a = torch.cat([out_e, out_o], dim=-1).reshape(3, L, n)
        length *= 2
    return scalar_mul_fixed(a, n_inv, ops) if inverse else a


def jacobians_to_host_affine(points_jac: torch.Tensor) -> list:
    """Jacobian [3, L, n] -> list of host affine (x, y), None at infinity."""
    return [HC.to_affine(pt) for pt in g1_ops.points_to_host(points_jac)]
