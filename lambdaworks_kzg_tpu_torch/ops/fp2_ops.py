"""Fp2 = Fp[u] / (u^2 + 1) in plain PyTorch (the JAX package's
`ops/fp2_ops.py`).

An element is an int64 tensor [..., 2, 24, B]: the component axis (c0,
c1), the Montgomery radix-2^16 limbs of `field_ops.FP`, the lanes. Any
leading axes batch independent elements, so the tower above
(`ops/tower_ops.py`) hands several products to one call: each function
makes one `FP.mul` call at most, where the JAX package makes one per
Fp product. Every result is fully reduced, so it equals the JAX
package's limb for limb however the products are grouped.
"""

import torch

from . import dispatch, limbs as lb
from .field_ops import FP

L = FP.L


def from_host(values, device="cuda") -> torch.Tensor:
    """[(c0, c1), ...] ints -> [2, L, B] Montgomery limbs on `device`."""
    device = dispatch.resolve_device(device)
    c0 = FP.to_mont_host([v[0] for v in values])
    c1 = FP.to_mont_host([v[1] for v in values])
    return torch.stack([lb.as_limb_tensor(c0, device), lb.as_limb_tensor(c1, device)])


def to_host(arr) -> list:
    """[2, L, B] -> [(c0, c1), ...] ints."""
    return list(zip(FP.from_mont_host(arr[0]), FP.from_mont_host(arr[1])))


def _pair(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1], dim=-3)


def add(a, b):
    return FP.add(a, b)


def sub(a, b):
    return FP.sub(a, b)


def neg(a):
    return FP.neg(a)


def double(a):
    return FP.add(a, a)


def conj(a):
    """The Frobenius x -> x^p: (c0, -c1)."""
    return _pair(a[..., 0, :, :], FP.neg(a[..., 1, :, :]))


def mul(a, b):
    """Karatsuba over u^2 = -1, three Fp products in one call:
    c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1."""
    a, b = torch.broadcast_tensors(a, b)
    s0, s1 = FP.add(torch.stack([a[..., 0, :, :], b[..., 0, :, :]]),
                    torch.stack([a[..., 1, :, :], b[..., 1, :, :]])).unbind(0)
    x = torch.cat([a, s0.unsqueeze(-3)], dim=-3)
    y = torch.cat([b, s1.unsqueeze(-3)], dim=-3)
    t0, t1, s = FP.mul(x, y).unbind(-3)
    c0, d = FP.sub(torch.stack([t0, s]), torch.stack([t1, t0])).unbind(0)
    return _pair(c0, FP.sub(d, t1))


def sqr(a):
    """Complex squaring, two Fp products in one call:
    c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1."""
    a0, a1 = a.unbind(-3)
    t, m = FP.mul(torch.stack([FP.add(a0, a1), a0], dim=-3),
                  torch.stack([FP.sub(a0, a1), a1], dim=-3)).unbind(-3)
    return _pair(t, FP.add(m, m))


def mul_by_nonresidue(a):
    """a (1 + u), the tower's non-residue xi (and the twist's b / 4)."""
    a0, a1 = a.unbind(-3)
    return _pair(FP.sub(a0, a1), FP.add(a0, a1))


def inv(a):
    """conj(a) / (a0^2 + a1^2), one Fermat inversion in Fp; 0 -> 0."""
    s0, s1 = FP.sqr(a).unbind(-3)
    t = FP.inv(FP.add(s0, s1))
    m0, m1 = FP.mul(a, t.unsqueeze(-3)).unbind(-3)
    return _pair(m0, FP.neg(m1))


def is_zero(a):
    """bool[..., B]."""
    return FP.is_zero(a).all(dim=-2)


def eq(a, b):
    return FP.eq(a, b).all(dim=-2)


class Fp2Field:
    """The field surface `ops/formulas.py` calls, over Fp2 elements
    [..., 2, L, B]."""

    L = L

    add = staticmethod(add)
    sub = staticmethod(sub)
    mul = staticmethod(mul)
    sqr = staticmethod(sqr)
    neg = staticmethod(neg)
    double = staticmethod(double)
    is_zero = staticmethod(is_zero)
    eq = staticmethod(eq)


FP2 = Fp2Field()
