"""The batched BLS12-381 ate pairing check (the JAX package's
`ops/pairing_ops.py`), the opt-in device pairing tier.

As in the JAX package:
- G2 points travel the Miller loop in homogeneous projective twist
  coordinates, so the doubling and addition steps need no inversion.
- Each step's line is a sparse Fp12 value (slots w^0, w^2, w^3) scaled
  by an Fp2 factor, which the final exponentiation's easy part kills.
- The final exponentiation's hard part uses the x-chain
  3 (p^4 - p^2 + 1) / r = (x - 1)^2 (x + p)(x^2 + p^2 - 1) + 3, so it
  computes FE(f)^3; gcd(3, r) = 1 keeps every `== 1` check.
- B pairs run one Miller loop side by side; their values multiply down
  to one, and one final exponentiation serves the batch.

Where the JAX package runs a `scan` over the static bits of |x| and
selects after computing both sides, these loops branch on the bits on
the host. The values are the same, at half the plain version's work.

`pairing_check` routes by the tensors' device through `ops/dispatch.py`:
on a CUDA device it makes one launch of `pairing_miller_loop` and one of
`pairing_final_exp` (`csrc/pairing.cu`); on the CPU it runs the plain
compositions below, `miller_loop_jac` and `final_exp_check`, which are
the kernels' plain versions. The Miller values themselves differ from
the host oracle's (`host/pairing.py`) by those Fp2 factors; FE(f)^3
equals the oracle's final exponentiation cubed.
"""

import torch

from ..constants import BLS_X
from ..host import curve as HC
from . import dispatch
from . import fp2_ops as F2
from . import g1_ops, g2_ops
from . import limbs as lb
from . import tower_ops as T
from .field_ops import FP

L = FP.L

# -- small multiples ---------------------------------------------------------------
# The JAX package forms 2a, 3a, 8a, 9a, 27a and 36a by chains of additions
# (on a TPU a product costs ~50 additions). Here each call costs its op
# count, so a step's multiples are one product by Montgomery constants:
# the same field values in one call instead of up to five per multiple.

_SMALL = {}


def _smul(values, ks):
    """[k_i a_i] for Fp2 values a_i of one shape and small ints k_i, in one
    Fp product."""
    a = torch.stack(values)
    key = (tuple(ks), str(a.device))
    if key not in _SMALL:
        k = lb.as_limb_tensor(FP.to_mont_host(ks), a.device)  # [L, n]
        _SMALL[key] = k.T.reshape((len(ks), 1, L, 1))
    return FP.mul(a, _SMALL[key]).unbind(0)


def _dbl(a):
    return F2.add(a, a)


def _smul_fp(a, s):
    """Fp2 [..., 2, L, B] times an Fp value [L, B]."""
    return FP.mul(a, s.unsqueeze(-3))


# -- the Miller loop's steps ------------------------------------------------------


def _dbl_step(T_pt, xp, yp):
    """T = (X, Y, Z) homogeneous projective on E'(Fp2), P = (xp, yp) G1
    affine [L, B] -> (2T, line (c0, c2, c3)):

      2T:   X3 = 2YZ (9X^4 - 8XY^2Z)
            Y3 = 36 X^3 Y^2 Z - 27 X^6 - 8 Y^4 Z^2
            Z3 = 8 Y^3 Z^3
      line (its value times w^3 2YZ^2):
            c0 = 3X^3 - 2Y^2Z,  c2 = -3 X^2 Z xp,  c3 = 2 Y Z^2 yp
    """
    X, Y, Z = T_pt
    X2, Y2, YZ = F2.mul(torch.stack([X, Y, Y]), torch.stack([X, Y, Z])).unbind(0)
    X3p, Y2Z, YZ2, X2Z = F2.mul(torch.stack([X2, Y2, YZ, X2]), torch.stack([X, Z, Z, Z])).unbind(0)
    X4, XY2Z, X3Y2, X6, Y4Z2, Y3Z3 = F2.mul(torch.stack([X3p, X, X3p, X3p, Y2Z, Y2Z]),
                                            torch.stack([X, Y2Z, Y2, X3p, Y2Z, YZ2])).unbind(0)
    lx, ly = _smul_fp(torch.stack([X2Z, YZ2]), torch.stack([xp, yp])).unbind(0)
    X4_9, XY2Z_8, X6_27, Y4Z2_8, Zn, X3p_3, Y2Z_2, lx_3, ly_2, YZ_2 = _smul(
        [X4, XY2Z, X6, Y4Z2, Y3Z3, X3p, Y2Z, lx, ly, YZ], [9, 8, 27, 8, 8, 3, 2, 3, 2, 2])
    X3Y2Z, Xn = F2.mul(torch.stack([X3Y2, YZ_2]),
                       torch.stack([Z, F2.sub(X4_9, XY2Z_8)])).unbind(0)
    (X3Y2Z_36,) = _smul([X3Y2Z], [36])
    Yn = F2.sub(F2.sub(X3Y2Z_36, X6_27), Y4Z2_8)
    c0 = F2.sub(X3p_3, Y2Z_2)
    return (Xn, Yn, Zn), (c0, F2.neg(lx_3), ly_2)


def _add_step(T_pt, q_aff, xp, yp):
    """T projective + Q = (xq, yq) affine on E'(Fp2). With N = Y - yq Z,
    D = X - xq Z:

      T+Q:  X3 = D (N^2 Z - D^2 (X + xq Z))
            Y3 = N (2 xq D^2 Z + D^2 X - N^2 Z) - yq D^3 Z
            Z3 = D^3 Z
      line (its value times w^3 D):
            c0 = N xq - yq D,  c2 = -N xp,  c3 = D yp
    """
    X, Y, Z = T_pt
    xq, yq = q_aff
    yqZ, xqZ = F2.mul(torch.stack([yq, xq]), torch.stack([Z, Z])).unbind(0)
    N, D = F2.sub(torch.stack([Y, X]), torch.stack([yqZ, xqZ])).unbind(0)
    N2, D2, Nxq, yqD = F2.mul(torch.stack([N, D, N, yq]), torch.stack([N, D, xq, D])).unbind(0)
    D3, D2Z, N2Z, D2X = F2.mul(torch.stack([D2, D2, N2, D2]), torch.stack([D, Z, Z, X])).unbind(0)
    xqD2Z, D3Z, yqD3 = F2.mul(torch.stack([D2Z, D3, yq]), torch.stack([xq, Z, D3])).unbind(0)
    Xn, NY, yqD3Z = F2.mul(torch.stack([F2.sub(N2Z, F2.add(D2X, xqD2Z)), N, yqD3]),
                           torch.stack([D, F2.sub(F2.add(_dbl(xqD2Z), D2X), N2Z), Z])).unbind(0)
    Yn = F2.sub(NY, yqD3Z)
    lx, ly = _smul_fp(torch.stack([N, D]), torch.stack([xp, yp])).unbind(0)
    c0 = F2.sub(Nxq, yqD)
    return (Xn, Yn, D3Z), (c0, F2.neg(lx), ly)


def _sparse_to_fp12(line):
    c0, c2, c3 = line
    zero = torch.zeros_like(c0)
    return ((c0, c2, zero), (zero, c3, zero))


_LOOP_BITS = [int(c) for c in bin(abs(BLS_X))[3:]]  # below the top bit


def _select12(mask, a, b):
    return T.unflatten12(lb.select(mask, T.flatten12(a), T.flatten12(b)))


def miller_loop(p_aff, q_aff, valid):
    """Per-lane Miller values: p_aff = (xp, yp) [L, B], q_aff = (xq, yq)
    [2, L, B], valid bool[B] (invalid lanes give f = 1). Returns an Fp12
    value over B lanes, conjugated for the negative x."""
    xp, yp = p_aff
    b = xp.shape[-1]
    one = T.fp12_one(b, xp.device)
    f = one
    T_pt = (q_aff[0], q_aff[1], T.fp2_one(b, xp.device))
    for bit in _LOOP_BITS:
        f = T.fp12_sqr(f)
        T_pt, line = _dbl_step(T_pt, xp, yp)
        f = T.fp12_mul(f, _sparse_to_fp12(line))
        if bit:
            T_pt, line = _add_step(T_pt, q_aff, xp, yp)
            f = T.fp12_mul(f, _sparse_to_fp12(line))
    return T.fp12_conj(_select12(valid, f, one))


def lane_product(f):
    """Multiply an Fp12 value's B lanes down to one: halves multiply
    pairwise, an odd count padded with one."""
    s = T.flatten12(f)
    while s.shape[-1] > 1:
        if s.shape[-1] % 2:
            s = torch.cat([s, T.flatten12(T.fp12_one(1, s.device))], dim=-1)
        h = s.shape[-1] // 2
        s = T.flatten12(T.fp12_mul(T.unflatten12(s[..., :h]), T.unflatten12(s[..., h:])))
    return T.unflatten12(s)


# -- the final exponentiation (x-chain, cubed) ----------------------------------

_X_BITS = [int(c) for c in bin(abs(BLS_X))[2:]]
_XM1_BITS = [int(c) for c in bin(abs(BLS_X - 1))[2:]]


def _pow_abs(m, bits):
    """m^e, e given by its bits from the top, for m in the cyclotomic
    subgroup only: square and multiply with Granger-Scott squarings."""
    r = T.fp12_one(m[0][0].shape[-1], m[0][0].device)
    for bit in bits:
        r = T.fp12_cyc_sqr(r)
        if bit:
            r = T.fp12_mul(r, m)
    return r


def final_exp_cubed(f):
    """FE(f)^3 through the x-chain (module docstring)."""
    t = T.fp12_mul(T.fp12_conj(f), T.fp12_inv(f))  # f^(p^6 - 1)
    m = T.fp12_mul(T.fp12_frobenius_n(t, 2), t)  # ^(p^2 + 1): cyclotomic
    # m^((x - 1)^2): the power by |x - 1| then conj, twice (x - 1 < 0)
    bm = T.fp12_conj(_pow_abs(m, _XM1_BITS))
    bm = T.fp12_conj(_pow_abs(bm, _XM1_BITS))
    c = T.fp12_mul(T.fp12_conj(_pow_abs(bm, _X_BITS)), T.fp12_frobenius(bm))  # ^(x + p)
    cx2 = T.fp12_conj(_pow_abs(T.fp12_conj(_pow_abs(c, _X_BITS)), _X_BITS))  # c^(x^2)
    g = T.fp12_mul(T.fp12_mul(cx2, T.fp12_frobenius_n(c, 2)), T.fp12_conj(c))  # ^(x^2 + p^2 - 1)
    return T.fp12_mul(g, T.fp12_mul(T.fp12_cyc_sqr(m), m))  # times m^3


# -- affine conversion, the kernels' plain versions, the public check ----------


def g1_to_affine(p_jac):
    """[3, L, B] Jacobian -> ((x, y) [L, B], valid bool[B]); lanes at
    infinity are invalid (their x and y are 0)."""
    X, Y, Z = p_jac.unbind(0)
    zi = FP.inv(Z)
    zi2 = FP.sqr(zi)
    zi3 = FP.mul(zi2, zi)
    x, y = FP.mul(torch.stack([X, Y]), torch.stack([zi2, zi3])).unbind(0)
    return (x, y), ~FP.is_zero(Z)


def g2_to_affine(q_jac):
    """[3, 2, L, B] Jacobian -> ((x, y) [2, L, B], valid bool[B])."""
    X, Y, Z = q_jac.unbind(0)
    zi = F2.inv(Z)
    zi2 = F2.sqr(zi)
    zi3 = F2.mul(zi2, zi)
    x, y = F2.mul(torch.stack([X, Y]), torch.stack([zi2, zi3])).unbind(0)
    return (x, y), ~F2.is_zero(Z)


def miller_loop_jac(ps_jac, qs_jac) -> torch.Tensor:
    """The plain version of the kernel pairing_miller_loop: G1 [3, L, B]
    and G2 [3, 2, L, B] Jacobian -> the Miller values as [12, L, B] Fp
    coefficients (`tower_ops.flatten12`), one at every invalid lane."""
    p_aff, p_fin = g1_to_affine(ps_jac)
    q_aff, q_fin = g2_to_affine(qs_jac)
    return T.flatten12(miller_loop(p_aff, q_aff, p_fin & q_fin))


def final_exp_check(f: torch.Tensor):
    """The plain version of the kernel pairing_final_exp: Miller values
    [12, L, B] -> (FE(prod f)^3 [12, L, 1], its `== 1` as bool[1])."""
    fe = final_exp_cubed(lane_product(T.unflatten12(f)))
    return T.flatten12(fe), T.fp12_eq_one(fe)


def pairing_check(ps_jac, qs_jac):
    """prod_i e(P_i, Q_i) == 1 for G1 Jacobian [3, L, B] and G2 Jacobian
    [3, 2, L, B]; pairs with a member at infinity contribute one, as in
    host/pairing.pairing_batch. Returns bool[1]."""
    f = dispatch.pairing_miller_loop(ps_jac, qs_jac)
    return dispatch.pairing_final_exp(f)[1]


def g1_neg(p_jac):
    return torch.stack([p_jac[0], FP.neg(p_jac[1]), p_jac[2]])


def pairings_verify(a1_jac, a2_jac, b1_jac, b2_jac):
    """e(a1, a2) == e(b1, b2) as e(-a1, a2) e(b1, b2) == 1; single points
    G1 [3, L, 1] and G2 [3, 2, L, 1]. Returns bool[1]."""
    ps = torch.cat([g1_neg(a1_jac), b1_jac], dim=-1)
    qs = torch.cat([a2_jac, b2_jac], dim=-1)
    return pairing_check(ps, qs)


def pairings_verify_host_points(a1, a2, b1, b2, device="cuda") -> bool:
    """Host Jacobian points (Python ints) -> the pairing check on
    `device`: the bridge `models/kzg.KZG` takes when
    `KZGConfig.device_pairing` is set."""
    device = dispatch.resolve_device(device)

    def d1(pt):
        aff, valid = g1_ops.make_points_host([None if HC.is_infinity(pt) else HC.to_affine(pt)])
        return g1_ops.lift(lb.as_limb_tensor(aff, device), torch.from_numpy(valid).to(device))

    def d2(pt):
        aff = None if HC.g2_is_infinity(pt) else HC.g2_to_affine(pt)
        return g2_ops.lift_affine(*g2_ops.make_points_host([aff], device))

    return bool(pairings_verify(d1(a1), d2(a2), d1(b1), d2(b2))[0])
