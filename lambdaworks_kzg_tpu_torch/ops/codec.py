"""Blob bytes -> plain Fr limbs (numpy, no Python loop over elements).

Blob field elements are 32-byte little-endian, so the radix-2^16 limb
array is the blob's bytes read as `<u2`. Canonicality (value < r) is
checked lexicographically over the limbs for the whole blob at once.
"""

import numpy as np

from ..constants import R
from . import limbs as lb

_R_LIMBS = lb.ints_to_limbs([R], 16)[:, 0]  # uint32[16], little-endian


def blob_to_limbs(blob: bytes, n: int) -> np.ndarray:
    """32n-byte blob -> uint32[16, n] plain Fr limbs (limbs-first).

    Raises ValueError on a wrong size or a non-canonical element."""
    if len(blob) != 32 * n:
        raise ValueError(f"blob must be {32 * n} bytes, got {len(blob)}")
    limbs = np.frombuffer(blob, dtype="<u2").reshape(n, 16).T.astype(np.uint32)
    if not np.all(_canonical_mask(limbs)):
        raise ValueError("non-canonical field element in blob (>= r)")
    return limbs


def _canonical_mask(limbs: np.ndarray) -> np.ndarray:
    """bool[n]: element < r, comparing limbs from the most significant."""
    n = limbs.shape[1]
    lt = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for i in range(15, -1, -1):
        col = limbs[i]
        ri = _R_LIMBS[i]
        lt |= ~decided & (col < ri)
        decided |= col != ri
    return lt  # rows equal to r stay False
