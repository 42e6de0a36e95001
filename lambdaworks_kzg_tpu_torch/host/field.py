"""Fp arithmetic over Python ints (the exact host oracle)."""

from ..constants import P


def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int):
    """Square root in Fp (p = 3 mod 4); None if a is not a square."""
    if a == 0:
        return 0
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


def batch_fp_inv(values):
    """Montgomery's batch inversion over Fp: one exponentiation for the
    whole list. Zero maps to zero."""
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v else 1) % P
    inv_all = fp_inv(prefix[-1])
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        v = values[i]
        if v:
            out[i] = prefix[i] * inv_all % P
            inv_all = inv_all * v % P
    return out
