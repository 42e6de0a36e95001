"""The evaluation domain over Python ints: bit-reversed roots of unity,
the Fr NTT that `ops/ntt.py` is held against, the barycentric evaluation
and quotient that `ops/fr_poly.py` is held against, and the G1 group FFT
that `ops/g1_batch.g1_fft_device` is held against (the port's copy of
the JAX package's `host/fft.py`, and of its host quotient)."""

from ..constants import R, fr_root_of_unity
from . import curve as C
from .field import batch_fr_inv


def bit_reversal_permutation(values):
    """Out-of-place bit-reversal reorder; len(values) is a power of two."""
    n = len(values)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    bits = n.bit_length() - 1
    return [values[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)]


def fr_roots_of_unity(order: int, inverse: bool = False):
    """[w^0, w^1, ..., w^(order-1)] for the primitive order-th root w
    (for w^-1 when inverse)."""
    w = fr_root_of_unity(order)
    if inverse:
        w = pow(w, R - 2, R)
    out = [1] * order
    for i in range(1, order):
        out[i] = out[i - 1] * w % R
    return out


def fr_fft(values, inverse: bool = False):
    """Radix-2 Cooley-Tukey NTT over Fr, natural order in and out; the
    inverse transform scales by 1/n."""
    n = len(values)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    a = bit_reversal_permutation([v % R for v in values])
    length = 2
    while length <= n:
        half = length // 2
        tw = fr_roots_of_unity(length, inverse)[:half]
        for start in range(0, n, length):
            for j in range(half):
                u = a[start + j]
                t = a[start + j + half] * tw[j] % R
                a[start + j] = (u + t) % R
                a[start + j + half] = (u - t) % R
        length *= 2
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


def g1_fft(points, inverse: bool = False):
    """Radix-2 FFT over G1 (Jacobian tuples), natural order in and out:
    butterflies are point additions, twiddles scalar multiplications.
    The inverse FFT of the setup's monomial powers is its Lagrange basis."""
    n = len(points)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    a = bit_reversal_permutation(list(points))
    length = 2
    while length <= n:
        w_len = fr_root_of_unity(length)
        if inverse:
            w_len = pow(w_len, R - 2, R)
        half = length // 2
        tw = [1] * half
        for i in range(1, half):
            tw[i] = tw[i - 1] * w_len % R
        for start in range(0, n, length):
            for j in range(half):
                u = a[start + j]
                t = C.point_scalar_mul(a[start + j + half], tw[j])
                a[start + j] = C.point_add(u, t)
                a[start + j + half] = C.point_add(u, C.point_neg(t))
        length *= 2
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [C.point_scalar_mul(pt, n_inv) for pt in a]
    return a


def barycentric_evaluate(evals_brp, z: int, order: int) -> int:
    """p(z) from p's evaluations on the bit-reversed roots:
    p(z) = (z^N - 1) / N * sum_i e_i w_i / (z - w_i), or the stored
    evaluation when z is a root."""
    roots_brp = bit_reversal_permutation(fr_roots_of_unity(order))
    z %= R
    for i, w in enumerate(roots_brp):
        if w == z:
            return evals_brp[i] % R
    inv_denoms = batch_fr_inv([(z - w) % R for w in roots_brp])
    total = sum(e * w % R * d % R for e, w, d in zip(evals_brp, roots_brp, inv_denoms)) % R
    total = total * ((pow(z, order, R) - 1) % R) % R
    return total * pow(order, R - 2, R) % R


def quotient(evals_brp, z: int, y: int, order: int):
    """q_i = (e_i - y) / (w_i - z) on the bit-reversed roots, for z
    outside the domain (the JAX `HostBackend.quotient` there)."""
    roots_brp = bit_reversal_permutation(fr_roots_of_unity(order))
    z %= R
    if z in roots_brp:
        raise ValueError("z lies in the domain")
    inv_denoms = batch_fr_inv([(w - z) % R for w in roots_brp])
    return [(e - y) * d % R for e, d in zip(evals_brp, inv_denoms)]
