"""BLS12-381 G1 and G2 over Python ints: group law, compression, MSM oracle.

Points are Jacobian (X, Y, Z) with Z == 0 meaning infinity; affine
points are (x, y) or None for infinity. G1 coordinates are ints, G2
coordinates Fp2 pairs (c0, c1). One Jacobian group law serves both,
over the coordinate field's operations (`FP_OPS`, `FP2_OPS`); the G1
names take no field argument, the G2 names start with `g2_`.
"""

from dataclasses import dataclass
from typing import Any, Callable

from ..constants import (
    B_G1, B_G2, BLS_X, G1_BETA, G1_GENERATOR_X, G1_GENERATOR_Y, G2_GENERATOR_X, G2_GENERATOR_Y,
    P, PSI_X, PSI_Y, R,
)
from . import field as F


@dataclass(frozen=True)
class FieldOps:
    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    neg: Callable
    inv: Callable
    is_zero: Callable
    zero: Any
    one: Any


FP_OPS = FieldOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    neg=lambda a: (-a) % P,
    inv=F.fp_inv,
    is_zero=lambda a: a % P == 0,
    zero=0,
    one=1,
)
FP2_OPS = FieldOps(
    add=F.fp2_add, sub=F.fp2_sub, mul=F.fp2_mul, sqr=F.fp2_sqr, neg=F.fp2_neg,
    inv=F.fp2_inv, is_zero=F.fp2_is_zero, zero=F.FP2_ZERO, one=F.FP2_ONE,
)

# -- the Jacobian group law of y^2 = x^3 + b over either field ---------------------


def _infinity(f: FieldOps):
    return (f.one, f.one, f.zero)


def _is_infinity(f: FieldOps, pt) -> bool:
    return f.is_zero(pt[2])


def _neg(f: FieldOps, pt):
    return (pt[0], f.neg(pt[1]), pt[2])


def _double(f: FieldOps, pt):
    X, Y, Z = pt
    if f.is_zero(Z) or f.is_zero(Y):
        return _infinity(f)
    add, sub, mul, sqr = f.add, f.sub, f.mul, f.sqr
    XX, YY, ZZ = sqr(X), sqr(Y), sqr(Z)
    YYYY = sqr(YY)
    S = sub(sub(sqr(add(X, YY)), XX), YYYY)
    S = add(S, S)
    M = add(add(XX, XX), XX)
    T = sub(sqr(M), add(S, S))
    Y8 = add(YYYY, YYYY)
    Y8 = add(Y8, Y8)
    Y8 = add(Y8, Y8)
    Z3 = sub(sub(sqr(add(Y, Z)), YY), ZZ)
    return (T, sub(mul(M, sub(S, T)), Y8), Z3)


def _add(f: FieldOps, p1, p2):
    if _is_infinity(f, p1):
        return p2
    if _is_infinity(f, p2):
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    add, sub, mul, sqr = f.add, f.sub, f.mul, f.sqr
    Z1Z1, Z2Z2 = sqr(Z1), sqr(Z2)
    U1, U2 = mul(X1, Z2Z2), mul(X2, Z1Z1)
    S1, S2 = mul(mul(Y1, Z2), Z2Z2), mul(mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        return _double(f, p1) if S1 == S2 else _infinity(f)
    H = sub(U2, U1)
    I = sqr(add(H, H))
    J = mul(H, I)
    d = sub(S2, S1)
    rr = add(d, d)
    V = mul(U1, I)
    X3 = sub(sub(sqr(rr), J), add(V, V))
    S1J = mul(S1, J)
    Y3 = sub(mul(rr, sub(V, X3)), add(S1J, S1J))
    Z3 = mul(sub(sub(sqr(add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def _scalar_mul_raw(f: FieldOps, pt, k: int):
    """[k]pt without reducing k mod r (k >= 0)."""
    result = _infinity(f)
    while k:
        if k & 1:
            result = _add(f, result, pt)
        pt = _double(f, pt)
        k >>= 1
    return result


def _to_affine(f: FieldOps, pt):
    if _is_infinity(f, pt):
        return None
    X, Y, Z = pt
    zinv = f.inv(Z)
    zinv2 = f.sqr(zinv)
    return (f.mul(X, zinv2), f.mul(Y, f.mul(zinv2, zinv)))


def _from_affine(f: FieldOps, aff):
    return _infinity(f) if aff is None else (aff[0], aff[1], f.one)


def _points_eq(f: FieldOps, p1, p2) -> bool:
    inf1, inf2 = _is_infinity(f, p1), _is_infinity(f, p2)
    if inf1 or inf2:
        return inf1 == inf2
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1, Z2Z2 = f.sqr(Z1), f.sqr(Z2)
    return (f.mul(X1, Z2Z2) == f.mul(X2, Z1Z1)
            and f.mul(f.mul(Y1, Z2), Z2Z2) == f.mul(f.mul(Y2, Z1), Z1Z1))


# -- G1 ------------------------------------------------------------------------------

INFINITY = _infinity(FP_OPS)
G1_GENERATOR = (G1_GENERATOR_X, G1_GENERATOR_Y, 1)


def is_infinity(pt) -> bool:
    return _is_infinity(FP_OPS, pt)


def point_neg(pt):
    return _neg(FP_OPS, pt)


def point_double(pt):
    return _double(FP_OPS, pt)


def point_add(p1, p2):
    return _add(FP_OPS, p1, p2)


def point_scalar_mul_raw(pt, k: int):
    return _scalar_mul_raw(FP_OPS, pt, k)


def point_scalar_mul(pt, k: int):
    return _scalar_mul_raw(FP_OPS, pt, k % R)


def to_affine(pt):
    """Jacobian -> (x, y), or None for infinity."""
    return _to_affine(FP_OPS, pt)


def from_affine(aff):
    return _from_affine(FP_OPS, aff)


def points_eq(p1, p2) -> bool:
    return _points_eq(FP_OPS, p1, p2)


def g1_in_subgroup(pt) -> bool:
    """Scott's endomorphism check: sigma(P) == -[x^2]P, where
    sigma(X, Y, Z) = (BETA X, Y, Z) acts as -x^2 on G1."""
    if is_infinity(pt):
        return True
    x_abs = -BLS_X
    X, Y, Z = pt
    sig = (X * G1_BETA % P, Y, Z)
    xxP = point_scalar_mul_raw(point_scalar_mul_raw(pt, x_abs), x_abs)
    return points_eq(sig, point_neg(xxP))


def g1_msm(scalars, points_affine):
    """sum_i scalars[i] * P_i by plain double-and-add (small oracle)."""
    if len(scalars) != len(points_affine):
        raise ValueError("scalar and point counts differ")
    acc = INFINITY
    for k, aff in zip(scalars, points_affine):
        if aff is not None and k % R:
            acc = point_add(acc, point_scalar_mul(from_affine(aff), k))
    return acc


# -- G2 ------------------------------------------------------------------------------

G2_INFINITY = _infinity(FP2_OPS)
G2_GENERATOR = (G2_GENERATOR_X, G2_GENERATOR_Y, F.FP2_ONE)


def g2_is_infinity(pt) -> bool:
    return _is_infinity(FP2_OPS, pt)


def g2_neg(pt):
    return _neg(FP2_OPS, pt)


def g2_add(p1, p2):
    return _add(FP2_OPS, p1, p2)


def g2_scalar_mul(pt, k: int):
    return _scalar_mul_raw(FP2_OPS, pt, k % R)


def g2_to_affine(pt):
    return _to_affine(FP2_OPS, pt)


def g2_from_affine(aff):
    return _from_affine(FP2_OPS, aff)


def g2_points_eq(p1, p2) -> bool:
    return _points_eq(FP2_OPS, p1, p2)


def g2_in_subgroup(pt) -> bool:
    """psi(Q) == [x]Q = -[|x|]Q (x < 0), psi the untwist-Frobenius-twist
    endomorphism: one 64-bit scalar multiplication instead of [r]Q."""
    if g2_is_infinity(pt):
        return True
    x, y = g2_to_affine(pt)
    psi = (F.fp2_mul(PSI_X, F.fp2_conj(x)), F.fp2_mul(PSI_Y, F.fp2_conj(y)), F.FP2_ONE)
    xQ = _scalar_mul_raw(FP2_OPS, pt, -BLS_X)
    return g2_points_eq(psi, g2_neg(xQ))


# -- compressed serialization (ZCash / blst layout) ----------------------------------

_COMPRESSED_BIT = 0x80
_INFINITY_BIT = 0x40
_SIGN_BIT = 0x20


def _fp_largest(y: int) -> bool:
    return y > (P - 1) // 2


def _fp2_largest(y) -> bool:
    """The ZCash rule for Fp2: compare c1 first, c0 when c1 is zero."""
    return _fp_largest(y[1]) if y[1] else _fp_largest(y[0])


def compress_g1(pt) -> bytes:
    aff = to_affine(pt)
    if aff is None:
        return bytes([0xC0]) + bytes(47)
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED_BIT
    if _fp_largest(y):
        out[0] |= _SIGN_BIT
    return bytes(out)


class DeserializationError(ValueError):
    pass


def _read_flags(data: bytes, size: int):
    """-> (flags, True for the point at infinity); raises on a bad length
    or encoding."""
    if len(data) != size:
        raise DeserializationError("bad length")
    flags = data[0]
    if not flags & _COMPRESSED_BIT:
        raise DeserializationError("uncompressed bit")
    if flags & _INFINITY_BIT:
        if flags != 0xC0 or any(data[1:]):
            raise DeserializationError("bad infinity encoding")
        return flags, True
    return flags, False


def decompress_g1(data: bytes, subgroup_check: bool = True):
    """48-byte compressed point -> Jacobian. Raises DeserializationError."""
    flags, at_infinity = _read_flags(data, 48)
    if at_infinity:
        return INFINITY
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise DeserializationError("x >= p")
    y = F.fp_sqrt((x * x % P * x + B_G1) % P)
    if y is None:
        raise DeserializationError("not on curve")
    if _fp_largest(y) != bool(flags & _SIGN_BIT):
        y = (-y) % P
    pt = (x, y, 1)
    if subgroup_check and not g1_in_subgroup(pt):
        raise DeserializationError("not in subgroup")
    return pt


def decompress_g2(data: bytes, subgroup_check: bool = True):
    """96-byte compressed point (x1 || x0) -> Jacobian G2. Raises
    DeserializationError."""
    flags, at_infinity = _read_flags(data, 96)
    if at_infinity:
        return G2_INFINITY
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise DeserializationError("x >= p")
    x = (x0, x1)
    y = F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), B_G2))
    if y is None:
        raise DeserializationError("not on curve")
    if _fp2_largest(y) != bool(flags & _SIGN_BIT):
        y = F.fp2_neg(y)
    pt = (x, y, F.FP2_ONE)
    if subgroup_check and not g2_in_subgroup(pt):
        raise DeserializationError("not in subgroup")
    return pt
