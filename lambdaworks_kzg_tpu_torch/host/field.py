"""The BLS12-381 field tower over Python ints (the exact host oracle).

  Fp   : int in [0, P)
  Fp2  : (c0, c1)            == c0 + c1 u,          u^2 = -1
  Fp6  : (a0, a1, a2) of Fp2 == a0 + a1 v + a2 v^2, v^3 = xi = u + 1
  Fp12 : (b0, b1) of Fp6     == b0 + b1 w,          w^2 = v

The port's copy of the JAX package's `host/field.py`; Fr helpers sit
beside Fp.
"""

from ..constants import P, R

# -- Fp and Fr ------------------------------------------------------------------


def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int):
    """Square root in Fp (p = 3 mod 4); None if a is not a square."""
    if a == 0:
        return 0
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


def fp_is_qr(a: int) -> bool:
    return a == 0 or pow(a, (P - 1) // 2, P) == 1


def batch_fr_inv(values):
    """Montgomery batch inversion over Fr; zero maps to zero."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % R
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v != 0:
            out[i] = prefix[i] * inv_all % R
            inv_all = inv_all * v % R
    return out


# -- Fp2 = Fp[u] / (u^2 + 1) ------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fp2_sqr(a):
    a0, a1 = a
    return ((a0 - a1) * (a0 + a1) % P, 2 * a0 * a1 % P)


def fp2_inv(a):
    a0, a1 = a
    norm_inv = pow(a0 * a0 + a1 * a1, P - 2, P)
    return (a0 * norm_inv % P, (-a1) * norm_inv % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_mul_by_xi(a):
    """a (1 + u), xi = 1 + u being Fp6's non-residue."""
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def fp2_is_zero(a) -> bool:
    return a[0] == 0 and a[1] == 0


def fp2_pow(a, e: int):
    result = FP2_ONE
    while e:
        if e & 1:
            result = fp2_mul(result, a)
        a = fp2_sqr(a)
        e >>= 1
    return result


def fp2_sqrt(a):
    """Square root in Fp2 through the norm; None if a is not a square."""
    a0, a1 = a
    if a1 == 0:
        if fp_is_qr(a0):
            return (fp_sqrt(a0), 0)
        t = fp_sqrt((-a0) % P)  # sqrt(a0) = t u with -t^2 = a0
        return None if t is None else (0, t)
    # s = alpha + beta u: alpha^2 - beta^2 = a0, 2 alpha beta = a1
    lam = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if lam is None:
        return None
    inv2 = (P + 1) // 2
    t = (a0 + lam) * inv2 % P
    if not fp_is_qr(t):
        t = (a0 - lam) * inv2 % P
        if not fp_is_qr(t):
            return None
    alpha = fp_sqrt(t)
    if alpha == 0:
        return None
    beta = a1 * inv2 % P * fp_inv(alpha) % P
    s = (alpha, beta)
    return s if fp2_sqr(s) == (a0 % P, a1 % P) else None


# -- Fp6 = Fp2[v] / (v^3 - xi) -----------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul_by_xi(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), t1), t2)))
    c1 = fp2_add(fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), t0), t1),
                 fp2_mul_by_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def fp6_mul_by_v(a):
    """(a0 + a1 v + a2 v^2) v = xi a2 + a0 v + a1 v^2."""
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(fp2_mul(a0, c0), fp2_mul_by_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))))
    t_inv = fp2_inv(t)
    return (fp2_mul(c0, t_inv), fp2_mul(c1, t_inv), fp2_mul(c2, t_inv))


# -- Fp12 = Fp6[w] / (w^2 - v) -----------------------------------------------------

FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    a0, a1 = a
    t = fp6_mul(a0, a1)
    c0 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1))), t),
                 fp6_mul_by_v(t))
    return (c0, fp6_add(t, t))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_inv(fp6_sub(fp6_mul(a0, a0), fp6_mul_by_v(fp6_mul(a1, a1))))
    return (fp6_mul(a0, t), fp6_neg(fp6_mul(a1, t)))


def fp12_conj(a):
    """a^(p^6): the inverse on the cyclotomic subgroup."""
    return (a[0], fp6_neg(a[1]))


def fp12_pow(a, e: int):
    """a^e for e >= 0."""
    result = FP12_ONE
    while e:
        if e & 1:
            result = fp12_mul(result, a)
        a = fp12_sqr(a)
        e >>= 1
    return result


# gamma_i = xi^(i (p - 1) / 6): a^p = sum_i conj(c_i) gamma_i w^i
FROBENIUS_GAMMA = tuple(fp2_pow(fp2_pow((1, 1), (P - 1) // 6), i) for i in range(6))


def fp12_frobenius(a):
    """a^p, with a = sum_{i<6} c_i w^i laid out as a[0] = (c0, c2, c4),
    a[1] = (c1, c3, c5)."""
    (c0, c2, c4), (c1, c3, c5) = a
    out = [fp2_mul(fp2_conj(c), FROBENIUS_GAMMA[i]) for i, c in enumerate((c0, c1, c2, c3, c4, c5))]
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))


def fp12_frobenius_n(a, n: int):
    for _ in range(n % 12):
        a = fp12_frobenius(a)
    return a
