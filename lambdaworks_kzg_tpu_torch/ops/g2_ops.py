"""The G2 (twist) group law in plain PyTorch (the JAX package's
`ops/g2_ops.py`).

The same Jacobian formulas as G1 (`ops/formulas.py`) over
`fp2_ops.FP2`. Points are int64 tensors [3, 2, L, B]: (X, Y, Z) with
Fp2 Montgomery coordinates; infinity is Z == (0, 0). The exceptional
lanes of `add` are patched with the JAX package's selects, so every
output limb, Z included, equals the JAX result. `scalar_mul_fixed`
branches on the host scalar's bits where the JAX package selects after
computing both sides; the values are the same.

The pairing tier (`ops/pairing_ops.py`) uses `make_points_host` and
`lift_affine`; the rest is the group law and the subgroup check.
"""

import torch

from ..constants import BLS_X, PSI_X, PSI_Y, R
from . import dispatch, fp2_ops as F2
from .field_ops import FP
from .formulas import jacobian_add_core, jacobian_dbl


def make_points_host(affine_list, device="cuda"):
    """[((x0, x1), (y0, y1)) | None, ...] -> ([2, 2, L, B] affine
    Montgomery coordinates, bool[B] valid) on `device`."""
    device = dispatch.resolve_device(device)
    xs = [(0, 0) if pt is None else pt[0] for pt in affine_list]
    ys = [(0, 0) if pt is None else pt[1] for pt in affine_list]
    valid = torch.tensor([pt is not None for pt in affine_list], dtype=torch.bool, device=device)
    return torch.stack([F2.from_host(xs, device), F2.from_host(ys, device)]), valid


def lift_affine(points_aff: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[2, 2, L, B] affine + valid -> [3, 2, L, B] Jacobian: Z = 1 on
    valid lanes, 0 (infinity) elsewhere."""
    one = FP.one_like(points_aff[0, 0])
    z = torch.stack([torch.where(valid.unsqueeze(0), one, 0), torch.zeros_like(one)])
    return torch.cat([points_aff, z.unsqueeze(0)], dim=0)


def points_to_host(points) -> list:
    """[3, 2, L, B] -> [((X0, X1), (Y0, Y1), (Z0, Z1)), ...] ints."""
    return list(zip(*(F2.to_host(points[k]) for k in range(3))))


def is_infinity(p):
    return F2.is_zero(p[2])


def _sel_pt(mask, a, b):
    return torch.where(mask.reshape(mask.shape[:-1] + (1, 1, 1) + mask.shape[-1:]), a, b)


def dbl(p):
    return torch.stack(jacobian_dbl(F2.FP2, p[0], p[1], p[2]))


def add(p, q):
    """Complete Jacobian addition on the twist."""
    f = F2.FP2
    X3, Y3, Z3, H, Rr = jacobian_add_core(f, p[0], p[1], p[2], q[0], q[1], q[2])
    out = torch.stack([X3, Y3, Z3])
    p_inf, q_inf = is_infinity(p), is_infinity(q)
    exceptional = ~p_inf & ~q_inf & f.is_zero(H)
    if exceptional.any():
        r_zero = f.is_zero(Rr)
        out = _sel_pt(exceptional & r_zero, dbl(p), out)
        out = _sel_pt(exceptional & ~r_zero, torch.zeros_like(out), out)
    out = _sel_pt(p_inf, q, out)
    return _sel_pt(q_inf, p, out)


def scalar_mul_fixed(points_jac, k: int):
    """[k]Q for a host-known scalar, every lane (double and add from the
    lowest bit)."""
    acc = torch.zeros_like(points_jac)
    base = points_jac
    for i in range(max(k.bit_length(), 1)):
        if (k >> i) & 1:
            acc = add(acc, base)
        base = dbl(base)
    return acc


_PSI = {}


def _psi_consts(device):
    key = str(device)
    if key not in _PSI:
        _PSI[key] = (F2.from_host([PSI_X], device), F2.from_host([PSI_Y], device))
    return _PSI[key]


def _jacobian_eq_mask(p, q):
    """bool[B]: p == q as twist points (cross-multiplied)."""
    f = F2.FP2
    Z11, Z22 = f.sqr(p[2]), f.sqr(q[2])
    ex = f.eq(f.mul(p[0], Z22), f.mul(q[0], Z11))
    ey = f.eq(f.mul(f.mul(p[1], q[2]), Z22), f.mul(f.mul(q[1], p[2]), Z11))
    inf1, inf2 = is_infinity(p), is_infinity(q)
    return torch.where(inf1 | inf2, inf1 == inf2, ex & ey)


def subgroup_mask(points_jac):
    """bool[B]: Q in G2, as psi(Q) == -[|x|]Q with psi(X, Y, Z) =
    (PSI_X conj(X), PSI_Y conj(Y), conj(Z)) in Jacobian coordinates."""
    xQ = scalar_mul_fixed(points_jac, -BLS_X)
    neg_xQ = torch.stack([xQ[0], F2.neg(xQ[1]), xQ[2]])
    px, py = _psi_consts(points_jac.device)
    psi = torch.stack([F2.mul(px, F2.conj(points_jac[0])), F2.mul(py, F2.conj(points_jac[1])),
                       F2.conj(points_jac[2])])
    return _jacobian_eq_mask(psi, neg_xQ)


def subgroup_mask_definitional(points_jac):
    """bool[B]: [r]Q == infinity (the oracle of the fast check)."""
    return is_infinity(scalar_mul_fixed(points_jac, R))
