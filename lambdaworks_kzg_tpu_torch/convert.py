"""Carry-across from the JAX package's arrays to the port's tensors.

The JAX package holds the commitment basis as uint32[2, 24, N]
Montgomery affine limbs plus bool[N] valid (`g1_ops.make_points_host`),
and its fixed-base table as uint32[2, 24, W N] plus valid (returned by
`msm.build_fixedbase_tables`, stored in `cache/fixedbase_*.npz`). These
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
