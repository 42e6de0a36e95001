"""Fp6 and Fp12 in plain PyTorch (the JAX package's `ops/tower_ops.py`).

    Fp2  = Fp[u]  / (u^2 + 1)     (ops/fp2_ops.py)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

At the public functions an Fp6 value is a 3-tuple of Fp2 tensors
[2, L, B] and an Fp12 value a 2-tuple of Fp6 values, the JAX package's
layout and the host oracle's (`host/field.py`). Inside, a function
stacks its operands (an Fp6 as [..., 3, 2, L, B], an Fp12 as
[..., 2, 3, 2, L, B]) so that the independent Fp2 products of one step
go to one `fp2_ops.mul` call: an Fp6 product is one call of 18 Fp
products, an Fp12 product one of 54. Every result is fully reduced, so
the values equal the JAX package's limb for limb. `flatten12` /
`unflatten12` give an Fp12 value as twelve Fp coefficients [12, L, B] in
the order of the tuples, which is how the pairing kernels
(`csrc/pairing.cu`) read and write it.
"""

import torch

from ..host import field as HF
from . import fp2_ops as F2
from .field_ops import FP

L = FP.L

# -- stacked layout ----------------------------------------------------------


def _s6(a) -> torch.Tensor:
    return torch.stack(list(a), dim=-4)


def _t6(s: torch.Tensor):
    return tuple(s.unbind(-4))


def _s12(a) -> torch.Tensor:
    return torch.stack([_s6(a[0]), _s6(a[1])], dim=-5)


def _t12(s: torch.Tensor):
    return tuple(_t6(c) for c in s.unbind(-5))


def flatten12(a) -> torch.Tensor:
    """Fp12 tuple -> [12, L, B]: coefficient 6 i + 2 j + k is a[i][j][k]."""
    s = _s12(a)
    return s.reshape((12,) + s.shape[-2:])


def unflatten12(f: torch.Tensor):
    return _t12(f.reshape((2, 3, 2) + f.shape[-2:]))


# -- constructors and host bridges ------------------------------------------


def fp2_zero(b: int, device="cuda") -> torch.Tensor:
    return F2.from_host([(0, 0)] * b, device)


def fp2_one(b: int, device="cuda") -> torch.Tensor:
    return F2.from_host([(1, 0)] * b, device)


def fp6_from_host(values, device="cuda"):
    """[((c00, c01), (c10, c11), (c20, c21)), ...] -> 3-tuple of [2, L, B]."""
    return tuple(F2.from_host([v[i] for v in values], device) for i in range(3))


def fp6_to_host(a):
    return list(zip(*(F2.to_host(c) for c in a)))


def fp12_from_host(values, device="cuda"):
    """Host Fp12 tuples -> 2-tuple of Fp6 values."""
    return tuple(fp6_from_host([v[i] for v in values], device) for i in range(2))


def fp12_to_host(a):
    return list(zip(fp6_to_host(a[0]), fp6_to_host(a[1])))


def fp12_one(b: int, device="cuda"):
    zero = fp2_zero(b, device)
    return ((fp2_one(b, device), zero, zero), (zero, zero, zero))


# -- Fp6 on stacked operands [..., 3, 2, L, B] -------------------------------


def _mul_by_v(s: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 v + a2 v^2) v = xi a2 + a0 v + a1 v^2."""
    a0, a1, a2 = s.unbind(-4)
    return torch.stack([F2.mul_by_nonresidue(a2), a0, a1], dim=-4)


def _mul6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Toom/Karatsuba interpolation: the six Fp2 products in one call.
    c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
    c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
    c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1,   ti = ai bi."""
    def operands(s):
        s0, s1, s2 = s.unbind(-4)
        sums = F2.add(torch.stack([s1, s0, s0], dim=-4), torch.stack([s2, s1, s2], dim=-4))
        return torch.cat([s, sums], dim=-4)

    t0, t1, t2, m12, m01, m02 = F2.mul(operands(a), operands(b)).unbind(-4)
    d = F2.sub(F2.sub(torch.stack([m12, m01, m02], dim=-4), torch.stack([t1, t0, t0], dim=-4)),
               torch.stack([t2, t1, t2], dim=-4))
    d0, d1, d2 = d.unbind(-4)
    x0, x2 = F2.mul_by_nonresidue(torch.stack([d0, t2], dim=-4)).unbind(-4)
    return F2.add(torch.stack([t0, d1, d2], dim=-4), torch.stack([x0, x2, t1], dim=-4))


def _inv6(a: torch.Tensor) -> torch.Tensor:
    """Cramer's rule over the cubic step; one Fp2 inversion. 0 -> 0.
    c0 = a0^2 - xi a1 a2, c1 = xi a2^2 - a0 a1, c2 = a1^2 - a0 a2,
    a^-1 = (c0, c1, c2) / (a0 c0 + xi (a2 c1 + a1 c2))."""
    a0, a1, a2 = a.unbind(-4)
    p = F2.mul(torch.stack([a0, a1, a2, a0, a1, a0], dim=-4),
               torch.stack([a0, a2, a2, a1, a1, a2], dim=-4))
    sq0, p12, sq2, p01, sq1, p02 = p.unbind(-4)
    x12, x22 = F2.mul_by_nonresidue(torch.stack([p12, sq2], dim=-4)).unbind(-4)
    c = F2.sub(torch.stack([sq0, x22, sq1], dim=-4), torch.stack([x12, p01, p02], dim=-4))
    c0, c1, c2 = c.unbind(-4)
    q0, q1, q2 = F2.mul(torch.stack([a0, a2, a1], dim=-4), c).unbind(-4)
    t = F2.add(q0, F2.mul_by_nonresidue(F2.add(q1, q2)))
    return F2.mul(c, F2.inv(t).unsqueeze(-4))


# -- Fp12 on stacked operands [..., 2, 3, 2, L, B] ---------------------------


def _mul12(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over w^2 = v, the three Fp6 products in one call:
    c0 = a0 b0 + v a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1."""
    def operands(s):
        s0, s1 = s.unbind(-5)
        return torch.stack([s0, s1, F2.add(s0, s1)], dim=-5)

    t0, t1, m = _mul6(operands(a), operands(b)).unbind(-5)
    c0 = F2.add(t0, _mul_by_v(t1))
    c1 = F2.sub(F2.sub(m, t0), t1)
    return torch.stack([c0, c1], dim=-5)


def _sqr12(a: torch.Tensor) -> torch.Tensor:
    """t = a0 a1, c0 = (a0 + a1)(a0 + v a1) - t - v t, c1 = 2 t; both Fp6
    products in one call."""
    a0, a1 = a.unbind(-5)
    x = torch.stack([a0, F2.add(a0, a1)], dim=-5)
    y = torch.stack([a1, F2.add(a0, _mul_by_v(a1))], dim=-5)
    t, u = _mul6(x, y).unbind(-5)
    c0 = F2.sub(F2.sub(u, t), _mul_by_v(t))
    return torch.stack([c0, F2.add(t, t)], dim=-5)


def _inv12(a: torch.Tensor) -> torch.Tensor:
    """a^-1 = (a0 t, -a1 t), t = (a0^2 - v a1^2)^-1."""
    sq0, sq1 = _mul6(a, a).unbind(-5)
    t = _inv6(F2.sub(sq0, _mul_by_v(sq1)))
    c0, c1 = _mul6(a, t.unsqueeze(-5)).unbind(-5)
    return torch.stack([c0, F2.neg(c1)], dim=-5)


def _fp4_sq(a, b):
    """(a + b s)^2 in Fp4 = Fp2[s] / (s^2 - xi): (a^2 + xi b^2, 2 a b),
    the three Fp2 squares in one call; a, b may carry leading axes."""
    t0, t1, s = F2.sqr(torch.stack([a, b, F2.add(a, b)])).unbind(0)
    return F2.add(t0, F2.mul_by_nonresidue(t1)), F2.sub(F2.sub(s, t0), t1)


def _tri_m(t, z):  # 3t - 2z
    r = F2.sub(t, z)
    return F2.add(F2.add(r, r), t)


def _tri_p(t, z):  # 3t + 2z
    r = F2.add(t, z)
    return F2.add(F2.add(r, r), t)


def _cyc_sqr12(g: torch.Tensor) -> torch.Tensor:
    """Granger-Scott squaring, right ONLY in the cyclotomic subgroup: with
    g = ((z0, z4, z3), (z2, z1, z5)), the squares in Fp4 of (z0, z1),
    (z2, z3) and (z4, z5) side by side, then 3t - 2z and 3t + 2z."""
    (z0, z4, z3), (z2, z1, z5) = _t12(g)
    o0, o1 = _fp4_sq(torch.stack([z0, z2, z4]), torch.stack([z1, z3, z5]))
    (a0, a1, a2), (b0, b1, b2) = o0.unbind(0), o1.unbind(0)
    n0, n4, n3 = _tri_m(torch.stack([a0, a1, a2]), torch.stack([z0, z4, z3])).unbind(0)
    n1, n5, n2 = _tri_p(torch.stack([b0, b1, F2.mul_by_nonresidue(b2)]),
                        torch.stack([z1, z5, z2])).unbind(0)
    return _s12(((n0, n4, n3), (n2, n1, n5)))


_GAMMA = {}


def _gamma(device) -> torch.Tensor:
    """[2, 3, 2, L, 1]: slot (i, j) holds gamma_k = xi^(k (p - 1) / 6),
    k = 2 j + i, from the port's own host field."""
    key = str(device)
    if key not in _GAMMA:
        g = [F2.from_host([HF.FROBENIUS_GAMMA[2 * j + i]], device)
             for i in range(2) for j in range(3)]
        _GAMMA[key] = torch.stack(g).reshape((2, 3, 2, L, 1))
    return _GAMMA[key]


def _frobenius12(a: torch.Tensor) -> torch.Tensor:
    """a^p: conjugate coefficient c_k of w^k and multiply it by gamma_k,
    all six products in one call."""
    return F2.mul(F2.conj(a), _gamma(a.device))


# -- the public functions, in the JAX package's tuple layout -----------------


def fp6_add(a, b):
    return _t6(F2.add(_s6(a), _s6(b)))


def fp6_sub(a, b):
    return _t6(F2.sub(_s6(a), _s6(b)))


def fp6_neg(a):
    return _t6(F2.neg(_s6(a)))


def fp6_mul(a, b):
    return _t6(_mul6(_s6(a), _s6(b)))


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    return (F2.mul_by_nonresidue(a[2]), a[0], a[1])


def fp6_inv(a):
    return _t6(_inv6(_s6(a)))


def fp6_is_zero(a):
    return F2.is_zero(_s6(a)).all(dim=0)


def fp12_mul(a, b):
    return _t12(_mul12(_s12(a), _s12(b)))


def fp12_sqr(a):
    return _t12(_sqr12(_s12(a)))


def fp12_inv(a):
    return _t12(_inv12(_s12(a)))


def fp12_conj(a):
    """The Frobenius p^6: the inverse on the cyclotomic subgroup (GT)."""
    return (a[0], fp6_neg(a[1]))


def fp12_cyc_sqr(g):
    return _t12(_cyc_sqr12(_s12(g)))


def fp12_eq_one(a):
    """bool[B]: a == 1 (Montgomery one in slot (0, 0), zeros elsewhere)."""
    s = _s12(a)
    one = fp2_one(1, s.device)
    rest = F2.is_zero(s.reshape((6,) + s.shape[-3:])[1:]).all(dim=0)
    return F2.eq(s[0, 0], one) & rest


def fp12_frobenius(a):
    return _t12(_frobenius12(_s12(a)))


def fp12_frobenius_n(a, n: int):
    s = _s12(a)
    for _ in range(n % 12):
        s = _frobenius12(s)
    return _t12(s)
