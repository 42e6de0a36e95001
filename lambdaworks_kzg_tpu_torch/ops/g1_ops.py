"""G1 point operations in plain PyTorch: the plain versions of the three
CUDA kernels (`ops/kernels.py`), and the CPU path.

Points are Jacobian (X, Y, Z) in Montgomery form, one [..., 3, L, B]
radix-2^16 int64 tensor (coordinate, limb, lane); infinity is Z == 0.
Affine inputs are [..., 2, L, B] with a separate validity mask. The
exceptional lanes are patched with the same selects as the JAX
package's `ops/g1_ops.py`, so every output limb, Z included, equals
the JAX result.
"""

import numpy as np
import torch

from .field_ops import FP
from .formulas import jacobian_add_core, jacobian_dbl, jacobian_madd_core

L = FP.L  # 24


def make_points_host(affine_list):
    """[(x, y) | None, ...] -> (uint32[2, L, N] Montgomery affine
    coordinates, bool[N] valid), numpy. Infinity rows are zeros."""
    xs = [0 if pt is None else pt[0] for pt in affine_list]
    ys = [0 if pt is None else pt[1] for pt in affine_list]
    out = np.stack([FP.to_mont_host(xs), FP.to_mont_host(ys)], axis=0)
    valid = np.asarray([pt is not None for pt in affine_list], dtype=bool)
    out[:, :, ~valid] = 0
    return out, valid


def points_to_host(points) -> list:
    """Jacobian [..., 3, L, B] Montgomery limbs -> list of (X, Y, Z) ints."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    arr = np.asarray(points)
    arr = arr.reshape((-1,) + arr.shape[-3:])
    out = []
    for g in range(arr.shape[0]):
        xs, ys, zs = (FP.from_mont_host(arr[g, k]) for k in range(3))
        out.extend(zip(xs, ys, zs))
    return out


def infinity_like(shape_prefix, batch: int, device="cpu") -> torch.Tensor:
    return torch.zeros(
        tuple(shape_prefix) + (3, L, batch), dtype=torch.int64, device=device
    )


def lift(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Affine [2, L, N] + valid -> Jacobian [3, L, N] (Z = 1 or 0)."""
    z = torch.where(valid.unsqueeze(0), FP.one_like(points[0]), 0)
    return torch.stack([points[0], points[1], z], dim=0)


def _sel_pt(mask, a, b):
    """mask ? a : b over [..., C, L, B] point tensors; mask [..., B]."""
    return torch.where(mask.unsqueeze(-2).unsqueeze(-2), a, b)


def dbl(p: torch.Tensor) -> torch.Tensor:
    """Jacobian doubling (dbl-2009-l)."""
    return torch.stack(jacobian_dbl(FP, *p.unbind(-3)), dim=-3)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian + Jacobian addition (add-2007-bl + selects)."""
    X1, Y1, Z1 = p.unbind(-3)
    X3, Y3, Z3, H, Rr = jacobian_add_core(FP, X1, Y1, Z1, *q.unbind(-3))
    out = torch.stack([X3, Y3, Z3], dim=-3)
    p_inf = FP.is_zero(Z1)
    q_inf = FP.is_zero(q[..., 2, :, :])
    same_x = ~p_inf & ~q_inf & FP.is_zero(H)
    if bool(same_x.any()):
        r_zero = FP.is_zero(Rr)
        out = _sel_pt(same_x & r_zero, dbl(p), out)
        out = _sel_pt(same_x & ~r_zero, torch.zeros_like(out), out)
    out = _sel_pt(p_inf, q, out)
    return _sel_pt(q_inf, p, out)


def madd(p: torch.Tensor, q_aff: torch.Tensor, q_valid: torch.Tensor) -> torch.Tensor:
    """Complete mixed addition: Jacobian p + affine q (madd-2007-bl).
    Lanes with q_valid False pass p through."""
    X1, Y1, Z1 = p.unbind(-3)
    X2, Y2 = q_aff.unbind(-3)
    X3, Y3, Z3, H, Rr = jacobian_madd_core(FP, X1, Y1, Z1, X2, Y2)
    out = torch.stack([X3, Y3, Z3], dim=-3)
    p_inf = FP.is_zero(Z1)
    same_x = q_valid & ~p_inf & FP.is_zero(H)
    if bool(same_x.any()):
        r_zero = FP.is_zero(Rr)
        out = _sel_pt(same_x & r_zero, dbl(p), out)
        out = _sel_pt(same_x & ~r_zero, torch.zeros_like(out), out)
    q_jac = torch.stack([X2, Y2, FP.one_like(X2)], dim=-3)
    out = _sel_pt(p_inf & q_valid, q_jac, out)
    return _sel_pt(~q_valid, p, out)


# -- the op-namespace interface of ops/dispatch.py, identity layout ---------


def to_op_layout(x16: torch.Tensor) -> torch.Tensor:
    return x16


def from_op_layout(x: torch.Tensor) -> torch.Tensor:
    return x
