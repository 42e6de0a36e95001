"""Blob <-> field-element codecs (the port's copy of the JAX package's
`utils/blob.py`).

A blob is a polynomial's evaluations on the bit-reversed roots-of-unity
domain, 32 little-endian bytes each. The coefficient bridge goes through
the host NTT `host/fft.fr_fft`, as the JAX package's does; `ops/ntt.py`
is its device counterpart.
"""

from typing import List, Sequence

from ..constants import BYTES_PER_FIELD_ELEMENT, R
from ..host import fft as FFT
from . import hashing as H


def blob_to_evaluations(blob: bytes, n: int) -> List[int]:
    """Blob -> n field elements (ValueError on a wrong size or a
    non-canonical element)."""
    if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
        raise ValueError(f"blob must be {n * BYTES_PER_FIELD_ELEMENT} bytes")
    return [H.bytes_to_bls_field(blob[i * 32 : (i + 1) * 32]) for i in range(n)]


def evaluations_to_blob(evals: Sequence[int]) -> bytes:
    """Field elements -> blob bytes of exactly their length."""
    return b"".join(H.bls_field_to_bytes(e % R) for e in evals)


def evaluations_to_blob_with_size(evals: Sequence[int], n: int) -> bytes:
    """Field elements -> a blob of n elements, zero-padded."""
    if len(evals) > n:
        raise ValueError("too many evaluations")
    return evaluations_to_blob(evals) + b"\x00" * ((n - len(evals)) * BYTES_PER_FIELD_ELEMENT)


def blob_to_coefficients(blob: bytes, n: int) -> List[int]:
    """Blob -> monomial coefficients: the inverse NTT of the evaluations
    put back in natural order."""
    evals_nat = FFT.bit_reversal_permutation(blob_to_evaluations(blob, n))
    return FFT.fr_fft(evals_nat, inverse=True)


def coefficients_to_blob(coeffs: Sequence[int], n: int) -> bytes:
    """Monomial coefficients -> blob: the NTT, then bit reversal."""
    if len(coeffs) > n:
        raise ValueError("too many coefficients")
    evals_nat = FFT.fr_fft(list(coeffs) + [0] * (n - len(coeffs)))
    return evaluations_to_blob(FFT.bit_reversal_permutation(evals_nat))
