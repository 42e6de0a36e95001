"""The BLS12-381 ate pairing over Python ints (the host verify tier).

The port's copy of the JAX package's `host/pairing.py`: G1 points and
untwisted G2 points are embedded in E(Fp12); an affine Miller loop over
|x| shares its squarings across the pairs; the final exponentiation is
the easy part (p^6 - 1)(p^2 + 1) by conjugation and Frobenius, then the
hard part (p^4 - p^2 + 1) / r as a plain exponent.
"""

from ..constants import BLS_X, P, R
from . import curve as C
from . import field as F


def _fp12_from_fp(a: int):
    return (((a, 0), F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)


def _fp12_from_fp2(a):
    return ((a, F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)


_W_INV = F.fp12_inv((F.FP6_ZERO, F.FP6_ONE))  # w = (0; 1, 0, 0)
_W2_INV = F.fp12_sqr(_W_INV)
_W3_INV = F.fp12_mul(_W2_INV, _W_INV)


def untwist(q_affine):
    """E'(Fp2) affine -> E(Fp12) affine: (x', y') -> (x' w^-2, y' w^-3)."""
    x, y = q_affine
    return (F.fp12_mul(_fp12_from_fp2(x), _W2_INV), F.fp12_mul(_fp12_from_fp2(y), _W3_INV))


def _line(lam, t, p):
    """The line of slope lam through T, evaluated at P."""
    return F.fp12_sub(F.fp12_sub(p[1], t[1]), F.fp12_mul(lam, F.fp12_sub(p[0], t[0])))


def _line_double(t, p):
    """(tangent at T evaluated at P, 2T)."""
    xt, yt = t
    lam = F.fp12_mul(F.fp12_mul(_fp12_from_fp(3), F.fp12_sqr(xt)),
                     F.fp12_inv(F.fp12_add(yt, yt)))
    x3 = F.fp12_sub(F.fp12_sqr(lam), F.fp12_add(xt, xt))
    y3 = F.fp12_sub(F.fp12_mul(lam, F.fp12_sub(xt, x3)), yt)
    return _line(lam, t, p), (x3, y3)


def _line_add(t, q, p):
    """(line through T and Q evaluated at P, T + Q)."""
    xt, yt = t
    xq, yq = q
    lam = F.fp12_mul(F.fp12_sub(yq, yt), F.fp12_inv(F.fp12_sub(xq, xt)))
    x3 = F.fp12_sub(F.fp12_sub(F.fp12_sqr(lam), xt), xq)
    y3 = F.fp12_sub(F.fp12_mul(lam, F.fp12_sub(xt, x3)), yt)
    return _line(lam, t, p), (x3, y3)


_LOOP_BITS = bin(abs(BLS_X))[3:]  # below the top bit


def miller_loop_batch(pairs):
    """pairs: [((xP, yP), (xQ, yQ))] embedded in Fp12 -> prod_i
    f_{|x|, Q_i}(P_i), conjugated for the negative x."""
    f = F.FP12_ONE
    ts = [q for _, q in pairs]
    for bit in _LOOP_BITS:
        f = F.fp12_sqr(f)
        for i, (pp, _) in enumerate(pairs):
            val, ts[i] = _line_double(ts[i], pp)
            f = F.fp12_mul(f, val)
        if bit == "1":
            for i, (pp, qq) in enumerate(pairs):
                val, ts[i] = _line_add(ts[i], qq, pp)
                f = F.fp12_mul(f, val)
    return F.fp12_conj(f)


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f):
    t = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))  # f^(p^6 - 1)
    t = F.fp12_mul(F.fp12_frobenius_n(t, 2), t)  # ^(p^2 + 1)
    return F.fp12_pow(t, _HARD_EXP)


def pairing_batch(pairs_g1_g2):
    """prod_i e(P_i, Q_i) for Jacobian G1 and G2 points; pairs with a
    point at infinity contribute one."""
    embedded = []
    for p1, q2 in pairs_g1_g2:
        if C.is_infinity(p1) or C.g2_is_infinity(q2):
            continue
        x, y = C.to_affine(p1)
        embedded.append(((_fp12_from_fp(x), _fp12_from_fp(y)), untwist(C.g2_to_affine(q2))))
    if not embedded:
        return F.FP12_ONE
    return final_exponentiation(miller_loop_batch(embedded))


def pairings_verify(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2), as e(-a1, a2) e(b1, b2) == 1."""
    return pairing_batch([(C.point_neg(a1), a2), (b1, b2)]) == F.FP12_ONE
