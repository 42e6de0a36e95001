"""Carry-across from the JAX package's arrays to the port's tensors.

The JAX package holds the commitment basis as uint32[2, 24, N]
Montgomery affine limbs plus bool[N] valid (`g1_ops.make_points_host`),
and its fixed-base table as uint32[2, 24, W N] plus valid (returned by
`msm.build_fixedbase_tables`, stored in `cache/fixedbase_*.npz`). Its
pairing tier holds an Fp2 value as uint32[2, 24, B] (`fp2_ops.from_host`)
and an Fp12 value as a 2-tuple of 3-tuples of those (`tower_ops`). These
functions take those arrays as numpy (and a setup's G1 and G2 powers as
the lists of affine points it holds) and return what the port takes.
"""

import numpy as np
import torch

from .models.srs import TrustedSetup
from .ops import limbs as lb


def setup_from_numpy(points, valid, digest: str = "converted", g2_monomial=(),
                     g1_monomial=()) -> TrustedSetup:
    """The basis as arrays, and optionally the JAX setup's `g2_monomial`
    and `g1_monomial` lists (affine points of Python ints, None for
    infinity), which verification needs."""
    points = np.asarray(points)
    valid = np.asarray(valid, dtype=bool)
    if points.ndim != 3 or points.shape[:2] != (2, 24):
        raise ValueError(f"points must be [2, 24, N], got {points.shape}")
    if valid.shape != points.shape[-1:]:
        raise ValueError("valid must be bool[N]")
    return TrustedSetup(points.astype(np.uint32), valid, digest, list(g1_monomial),
                        list(g2_monomial))


def fixedbase_from_numpy(table, valid, device="cuda"):
    """([2, 24, W N] u32, bool[W N]) -> (int64 tensor, bool tensor)."""
    table = np.asarray(table)
    valid = np.asarray(valid, dtype=bool)
    if table.ndim != 3 or table.shape[:2] != (2, 24) or valid.shape != table.shape[-1:]:
        raise ValueError("table must be [2, 24, M] with valid bool[M]")
    return lb.as_limb_tensor(table, device), torch.from_numpy(valid).to(device)


def fixedbase_from_npz(path: str, device="cuda"):
    with np.load(path) as data:
        return fixedbase_from_numpy(data["table"], data["valid"], device)


def fp2_from_numpy(arr, device="cuda") -> torch.Tensor:
    """uint32[2, 24, B] (or any leading axes before [2, 24, B]) -> the
    port's int64 Fp2 tensor on `device`."""
    arr = np.asarray(arr)
    if arr.ndim < 3 or arr.shape[-3:-1] != (2, 24):
        raise ValueError(f"an Fp2 array must be [..., 2, 24, B], got {arr.shape}")
    return lb.as_limb_tensor(arr, device)


def fp12_from_numpy(value, device="cuda"):
    """((a0, a1, a2), (b0, b1, b2)) of uint32[2, 24, B] -> the same tuples
    of the port's Fp2 tensors."""
    if len(value) != 2 or any(len(half) != 3 for half in value):
        raise ValueError("an Fp12 value is a 2-tuple of 3-tuples of Fp2 arrays")
    return tuple(tuple(fp2_from_numpy(c, device) for c in half) for half in value)
