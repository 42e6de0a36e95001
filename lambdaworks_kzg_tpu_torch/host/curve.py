"""BLS12-381 G1 over Python ints: group law, compression, MSM oracle.

Points are Jacobian (X, Y, Z) with Z == 0 meaning infinity; affine
points are (x, y) or None for infinity.
"""

from ..constants import B_G1, BLS_X, G1_BETA, G1_GENERATOR_X, G1_GENERATOR_Y, P, R
from . import field as F

INFINITY = (1, 1, 0)
G1_GENERATOR = (G1_GENERATOR_X, G1_GENERATOR_Y, 1)


def is_infinity(pt) -> bool:
    return pt[2] % P == 0


def point_neg(pt):
    return (pt[0], (-pt[1]) % P, pt[2])


def point_double(pt):
    X, Y, Z = pt
    if Z == 0 or Y == 0:
        return INFINITY
    XX = X * X % P
    YY = Y * Y % P
    YYYY = YY * YY % P
    ZZ = Z * Z % P
    S = 2 * ((X + YY) ** 2 - XX - YYYY) % P
    M = 3 * XX % P
    T = (M * M - 2 * S) % P
    Y3 = (M * (S - T) - 8 * YYYY) % P
    Z3 = ((Y + Z) ** 2 - YY - ZZ) % P
    return (T, Y3, Z3)


def point_add(p1, p2):
    if is_infinity(p1):
        return p2
    if is_infinity(p2):
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        return point_double(p1) if S1 == S2 else INFINITY
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) ** 2 - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def point_scalar_mul_raw(pt, k: int):
    """[k]pt without reducing k mod r (k >= 0)."""
    result = INFINITY
    while k:
        if k & 1:
            result = point_add(result, pt)
        pt = point_double(pt)
        k >>= 1
    return result


def point_scalar_mul(pt, k: int):
    return point_scalar_mul_raw(pt, k % R)


def to_affine(pt):
    """Jacobian -> (x, y), or None for infinity."""
    if is_infinity(pt):
        return None
    X, Y, Z = pt
    zinv = F.fp_inv(Z)
    zinv2 = zinv * zinv % P
    return (X * zinv2 % P, Y * zinv2 * zinv % P)


def from_affine(aff):
    return INFINITY if aff is None else (aff[0], aff[1], 1)


def points_eq(p1, p2) -> bool:
    inf1, inf2 = is_infinity(p1), is_infinity(p2)
    if inf1 or inf2:
        return inf1 == inf2
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1, Z2Z2 = Z1 * Z1 % P, Z2 * Z2 % P
    return (X1 * Z2Z2 - X2 * Z1Z1) % P == 0 and (
        Y1 * Z2 * Z2Z2 - Y2 * Z1 * Z1Z1
    ) % P == 0


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


_COMPRESSED_BIT = 0x80
_INFINITY_BIT = 0x40
_SIGN_BIT = 0x20


def compress_g1(pt) -> bytes:
    aff = to_affine(pt)
    if aff is None:
        return bytes([0xC0]) + bytes(47)
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED_BIT
    if y > (P - 1) // 2:
        out[0] |= _SIGN_BIT
    return bytes(out)


class DeserializationError(ValueError):
    pass


def decompress_g1(data: bytes, subgroup_check: bool = True):
    """48-byte compressed point -> Jacobian. Raises DeserializationError."""
    if len(data) != 48:
        raise DeserializationError("bad length")
    flags = data[0]
    if not flags & _COMPRESSED_BIT:
        raise DeserializationError("uncompressed bit")
    if flags & _INFINITY_BIT:
        if flags != 0xC0 or any(data[1:]):
            raise DeserializationError("bad infinity encoding")
        return INFINITY
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise DeserializationError("x >= p")
    y = F.fp_sqrt((x * x % P * x + B_G1) % P)
    if y is None:
        raise DeserializationError("not on curve")
    if (y > (P - 1) // 2) != bool(flags & _SIGN_BIT):
        y = (-y) % P
    pt = (x, y, 1)
    if subgroup_check and not g1_in_subgroup(pt):
        raise DeserializationError("not in subgroup")
    return pt


def g1_msm(scalars, points_affine):
    """sum_i scalars[i] * P_i by plain double-and-add (small oracle)."""
    if len(scalars) != len(points_affine):
        raise ValueError("scalar and point counts differ")
    acc = INFINITY
    for k, aff in zip(scalars, points_affine):
        if aff is not None and k % R:
            acc = point_add(acc, point_scalar_mul(from_affine(aff), k))
    return acc
