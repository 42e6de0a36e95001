"""Fiat-Shamir challenges and field-element bytes (hashlib only).

The port's copy of the JAX package's `utils/hashing.py`: a sha256 digest
becomes an Fr element read little-endian and reduced mod r, as the
consensus-spec vectors require.
"""

import hashlib
from typing import List, Sequence

from ..constants import (
    FIAT_SHAMIR_PROTOCOL_DOMAIN, FIELD_ELEMENTS_PER_BLOB, R, RANDOM_CHALLENGE_KZG_BATCH_DOMAIN,
)


def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "little") % R


def bytes_to_bls_field(b: bytes) -> int:
    """32 bytes little-endian -> Fr; ValueError unless canonical (< r)."""
    if len(b) != 32:
        raise ValueError("field element must be 32 bytes")
    v = int.from_bytes(b, "little")
    if v >= R:
        raise ValueError("non-canonical field element")
    return v


def bls_field_to_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "little")


def compute_challenge(blob: bytes, commitment: bytes,
                      field_elements_per_blob: int = FIELD_ELEMENTS_PER_BLOB) -> int:
    """sha256(domain || u64le(n) || u64le(0) || blob || commitment) -> Fr."""
    if len(blob) != 32 * field_elements_per_blob or len(commitment) != 48:
        raise ValueError("blob or commitment of the wrong size")
    return hash_to_bls_field(
        FIAT_SHAMIR_PROTOCOL_DOMAIN
        + field_elements_per_blob.to_bytes(8, "little")
        + (0).to_bytes(8, "little")
        + blob
        + commitment
    )


def compute_powers(x: int, n: int) -> List[int]:
    """[x^0, x^1, ..., x^(n-1)] mod r."""
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * x % R
    return out


def compute_r_powers(commitments: Sequence[bytes], zs: Sequence[int], ys: Sequence[int],
                     proofs: Sequence[bytes],
                     field_elements_per_blob: int = FIELD_ELEMENTS_PER_BLOB) -> List[int]:
    """Powers of r = sha256(domain || u64le(n) || u64le(k) || k x (C || z
    || y || proof)), z and y little-endian, for the batch check."""
    data = bytearray(
        RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
        + field_elements_per_blob.to_bytes(8, "little")
        + len(commitments).to_bytes(8, "little")
    )
    for c, z, y, pr in zip(commitments, zs, ys, proofs):
        data += c + bls_field_to_bytes(z) + bls_field_to_bytes(y) + pr
    return compute_powers(hash_to_bls_field(bytes(data)), len(commitments))
