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
