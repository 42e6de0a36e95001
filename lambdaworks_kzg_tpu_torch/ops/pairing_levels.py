"""The level programs of the pairing kernels (`csrc/pairing.cu`).

Both kernels run one thread block of 224 threads (56 groups of the four
threads of `fp_coop.cuh`) as a machine of levels over field values held
in shared memory. A program is a list of subroutines, each a list of
phases, and the kernel calls the subroutines in the order the pairing
needs (per bit of |x| in the Miller loop, per bit of |x| and |x - 1| in
the final exponentiation). A phase is one of:

  MUL   up to 56 independent Fp products, one per group (fpc::mul);
  LIN   up to 224 linear combinations, one per thread: out = sum c_i x_i
        mod p for small signed integers c_i, summed lazily in 64-bit words
        and reduced once;
  INV   up to 7 Fp inversions, one per warp (a binary extended Euclid
        on one thread, then a product by R^3);

and a `__syncthreads()` ends each. Each subroutine is written here as
straight-line code over Fp values (the tower's formulas, the plain
versions' polynomials), and `schedule` turns it into phases: products go
to the earliest level their operands allow, 56 at most (the longest
remaining chain first); the additions between two levels collapse into
as few waves as a cap on the terms of one entry allows; values get slots
in shared memory by
a linear scan, so that no phase writes a slot that it also reads.

Every value is a fully reduced field element, so any order of products
and additions gives the same words; the polynomials of the Miller
loop's projective steps are the plain version's (`pairing_ops._dbl_step`
and `_add_step`), only evaluated in fewer levels, so the kernels equal
the plain versions limb for limb.

`emulate_miller_loop` and `emulate_final_exp` run a program on Python
ints the way the kernels run it (plain field values: the Montgomery map
commutes with every phase), so the CPU tests hold the programs against
the plain versions and the host pairing; the card runs them.
"""

import functools
from dataclasses import dataclass

from ..constants import BLS_X, P

MUL, LIN, INV = 1, 2, 3
GROUPS = 56  # products a MUL phase holds: 224 threads, four to a product
THREADS = 224  # linear entries a LIN phase holds
INV_MAX = 7  # inversions an INV phase holds: one thread in each warp
WORDS = 12  # u32 words per slot
LIN_CAP = 48  # the most terms one linear entry may have after inlining
COEF_MAX = 1 << 14  # |c_i| of one term
COEF_SUM_MAX = 1 << 19  # sum |c_i| of one entry (the kernel's 64-bit sums)

# the header of an encoded program (int32 words; csrc/levels.cuh reads the
# same offsets)
H_SLOTS, H_TABLE = 0, 1
H_SUBS = 2  # (first phase, phase count) per subroutine
MAX_SUBS = 12
H_IO = H_SUBS + 2 * MAX_SUBS  # the slots the kernel loads and stores
IO_LEN = 64
HEADER = H_IO + IO_LEN

X_ABS = -BLS_X
XM1_ABS = -(BLS_X - 1)


# -- straight-line code over Fp values -------------------------------------


class Code:
    """One subroutine as SSA over Fp values: inputs are named state slots,
    `mul`, `inv` and `lin` make new values, `output` writes a value to a
    named state slot at the end."""

    def __init__(self, name: str):
        self.name = name
        self.kind = []  # "in", "mul", "inv", "lin"
        self.args = []  # in: state name; mul: (a, b); inv: (a,); lin: {node: coef}
        self.outputs = []  # (state name, node)
        self._inputs = {}

    def _node(self, kind, args) -> int:
        self.kind.append(kind)
        self.args.append(args)
        return len(self.kind) - 1

    def inp(self, name: str) -> int:
        if name not in self._inputs:
            self._inputs[name] = self._node("in", name)
        return self._inputs[name]

    def mul(self, a: int, b: int) -> int:
        return self._node("mul", (a, b))

    def inv(self, a: int) -> int:
        return self._node("inv", (a,))

    def lin(self, terms) -> int:
        acc = {}
        for c, v in terms:
            acc[v] = acc.get(v, 0) + c
        acc = {v: c for v, c in acc.items() if c}
        if len(acc) == 1:
            (v, c), = acc.items()
            if c == 1:
                return v
        return self._node("lin", acc)

    def add(self, a, b):
        return self.lin([(1, a), (1, b)])

    def sub(self, a, b):
        return self.lin([(1, a), (-1, b)])

    def neg(self, a):
        return self.lin([(-1, a)])

    def scale(self, a, k: int):
        return self.lin([(k, a)])

    def zero(self):
        return self._node("lin", {})

    def output(self, name: str, node: int) -> None:
        if any(n == name for n, _ in self.outputs):
            raise ValueError(f"{self.name}: {name} is written twice")
        self.outputs.append((name, node))


# -- the tower over Code values --------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1), Fp6 = Fp2[v] / (v^3 - xi), xi = 1 + u,
# Fp12 = Fp6[w] / (w^2 - v): the plain tower's formulas (ops/fp2_ops.py,
# ops/tower_ops.py); an Fp2 value is a pair of nodes, an Fp6 a triple of
# Fp2, an Fp12 a pair of Fp6.


def add2(c, a, b):
    return (c.add(a[0], b[0]), c.add(a[1], b[1]))


def sub2(c, a, b):
    return (c.sub(a[0], b[0]), c.sub(a[1], b[1]))


def neg2(c, a):
    return (c.neg(a[0]), c.neg(a[1]))


def scale2(c, a, k):
    return (c.scale(a[0], k), c.scale(a[1], k))


def conj2(c, a):
    return (a[0], c.neg(a[1]))


def mul_xi(c, a):
    return (c.sub(a[0], a[1]), c.add(a[0], a[1]))


def mul2(c, a, b):
    """Karatsuba: three Fp products."""
    t0, t1 = c.mul(a[0], b[0]), c.mul(a[1], b[1])
    s = c.mul(c.add(a[0], a[1]), c.add(b[0], b[1]))
    return (c.sub(t0, t1), c.lin([(1, s), (-1, t0), (-1, t1)]))


def sqr2(c, a):
    """(a0 + a1)(a0 - a1), 2 a0 a1: two Fp products."""
    m = c.mul(a[0], a[1])
    return (c.mul(c.add(a[0], a[1]), c.sub(a[0], a[1])), c.scale(m, 2))


def mul2_fp(c, a, s):
    return (c.mul(a[0], s), c.mul(a[1], s))


def zero2(c):
    return (c.zero(), c.zero())


def add6(c, a, b):
    return tuple(add2(c, x, y) for x, y in zip(a, b))


def sub6(c, a, b):
    return tuple(sub2(c, x, y) for x, y in zip(a, b))


def neg6(c, a):
    return tuple(neg2(c, x) for x in a)


def mul_v(c, a):
    return (mul_xi(c, a[2]), a[0], a[1])


def mul6(c, a, b):
    """Toom/Karatsuba interpolation, six Fp2 products (tower_ops._mul6)."""
    t0, t1, t2 = mul2(c, a[0], b[0]), mul2(c, a[1], b[1]), mul2(c, a[2], b[2])
    m12 = mul2(c, add2(c, a[1], a[2]), add2(c, b[1], b[2]))
    m01 = mul2(c, add2(c, a[0], a[1]), add2(c, b[0], b[1]))
    m02 = mul2(c, add2(c, a[0], a[2]), add2(c, b[0], b[2]))
    r0 = add2(c, t0, mul_xi(c, sub2(c, sub2(c, m12, t1), t2)))
    r1 = add2(c, sub2(c, sub2(c, m01, t0), t1), mul_xi(c, t2))
    r2 = add2(c, sub2(c, sub2(c, m02, t0), t2), t1)
    return (r0, r1, r2)


def mul6_01(c, a, x0, x1):
    """a (x0 + x1 v): five Fp2 products."""
    p00, p11 = mul2(c, a[0], x0), mul2(c, a[1], x1)
    p20, p21 = mul2(c, a[2], x0), mul2(c, a[2], x1)
    k = mul2(c, add2(c, a[0], a[1]), add2(c, x0, x1))
    return (add2(c, p00, mul_xi(c, p21)), sub2(c, sub2(c, k, p00), p11), add2(c, p11, p20))


def mul6_1(c, a, y):
    """a (y v) = (xi a2 y, a0 y, a1 y): three Fp2 products."""
    return (mul_xi(c, mul2(c, a[2], y)), mul2(c, a[0], y), mul2(c, a[1], y))


def inv2(c, a):
    """conj(a) / (a0^2 + a1^2): one Fp inversion."""
    t = c.inv(c.add(c.mul(a[0], a[0]), c.mul(a[1], a[1])))
    return (c.mul(a[0], t), c.neg(c.mul(a[1], t)))


def inv6(c, a):
    """Cramer's rule (tower_ops._inv6)."""
    c0 = sub2(c, sqr2(c, a[0]), mul_xi(c, mul2(c, a[1], a[2])))
    c1 = sub2(c, mul_xi(c, sqr2(c, a[2])), mul2(c, a[0], a[1]))
    c2 = sub2(c, sqr2(c, a[1]), mul2(c, a[0], a[2]))
    t = add2(c, mul2(c, a[0], c0), mul_xi(c, add2(c, mul2(c, a[2], c1), mul2(c, a[1], c2))))
    ti = inv2(c, t)
    return (mul2(c, c0, ti), mul2(c, c1, ti), mul2(c, c2, ti))


def mul12(c, a, b):
    """Karatsuba over w^2 = v: three Fp6 products, 54 Fp products."""
    t0, t1 = mul6(c, a[0], b[0]), mul6(c, a[1], b[1])
    m = mul6(c, add6(c, a[0], a[1]), add6(c, b[0], b[1]))
    return (add6(c, t0, mul_v(c, t1)), sub6(c, sub6(c, m, t0), t1))


def sqr12(c, a):
    """t = a0 a1, c0 = (a0 + a1)(a0 + v a1) - t - v t, c1 = 2 t: 36 products."""
    t = mul6(c, a[0], a[1])
    u = mul6(c, add6(c, a[0], a[1]), add6(c, a[0], mul_v(c, a[1])))
    return (sub6(c, sub6(c, u, t), mul_v(c, t)), add6(c, t, t))


def mul12_line(c, f, l0, l2, l3):
    """f times the sparse line ((l0, l2, 0), (0, l3, 0)): 13 Fp2 products
    (39 Fp products) where a full Fp12 product takes 18."""
    t0 = mul6_01(c, f[0], l0, l2)
    t1 = mul6_1(c, f[1], l3)
    m = mul6_01(c, add6(c, f[0], f[1]), l0, add2(c, l2, l3))
    return (add6(c, t0, mul_v(c, t1)), sub6(c, sub6(c, m, t0), t1))


def conj12(c, a):
    return (a[0], neg6(c, a[1]))


def inv12(c, a):
    """(a0 t, -a1 t), t = (a0^2 - v a1^2)^-1 (tower_ops._inv12)."""
    s = sub6(c, mul6(c, a[0], a[0]), mul_v(c, mul6(c, a[1], a[1])))
    t = inv6(c, s)
    return (mul6(c, a[0], t), neg6(c, mul6(c, a[1], t)))


def sqr2_direct(c, a):
    """a0^2 - a1^2, 2 a0 a1: three Fp products of a's own words, so the
    level needs no sums formed before it."""
    s0, s1, m = c.mul(a[0], a[0]), c.mul(a[1], a[1]), c.mul(a[0], a[1])
    return (c.sub(s0, s1), c.scale(m, 2))


def mul2_direct(c, a, b):
    """a0 b0 - a1 b1, a0 b1 + a1 b0: four Fp products, no sums before."""
    return (c.sub(c.mul(a[0], b[0]), c.mul(a[1], b[1])),
            c.add(c.mul(a[0], b[1]), c.mul(a[1], b[0])))


def cyc_sqr12(c, g):
    """Granger-Scott squaring (tower_ops._cyc_sqr12). Its Fp4 squares take
    a^2, b^2 and 2ab from 30 products of g's own words (one level; the
    Karatsuba forms take 18 but need a wave of sums before the level)."""
    (z0, z4, z3), (z2, z1, z5) = g

    def fp4_sqr(a, b):
        t0, t1 = sqr2_direct(c, a), sqr2_direct(c, b)
        return add2(c, t0, mul_xi(c, t1)), scale2(c, mul2_direct(c, a, b), 2)

    def tri_m(t, z):  # 3t - 2z
        return (c.lin([(3, t[0]), (-2, z[0])]), c.lin([(3, t[1]), (-2, z[1])]))

    def tri_p(t, z):  # 3t + 2z
        return (c.lin([(3, t[0]), (2, z[0])]), c.lin([(3, t[1]), (2, z[1])]))

    a0, b0 = fp4_sqr(z0, z1)
    a1, b1 = fp4_sqr(z2, z3)
    a2, b2 = fp4_sqr(z4, z5)
    return ((tri_m(a0, z0), tri_m(a1, z4), tri_m(a2, z3)),
            (tri_p(mul_xi(c, b2), z2), tri_p(b0, z1), tri_p(b1, z5)))


def _coeffs(a):
    """Fp12 -> its six Fp2 coefficients c_k of w^k: c_(2j) = a.c0.cj,
    c_(2j+1) = a.c1.cj."""
    return [a[k % 2][k // 2] for k in range(6)]


def _from_coeffs(cs):
    return ((cs[0], cs[2], cs[4]), (cs[1], cs[3], cs[5]))


def frob12(c, a, gamma):
    """a^p: c_k -> conj(c_k) gamma_k (gamma_0 = 1 needs no product)."""
    cs = _coeffs(a)
    return _from_coeffs([conj2(c, cs[0])]
                        + [mul2(c, conj2(c, cs[k]), gamma[k]) for k in range(1, 6)])


def frob12_2(c, a, delta):
    """a^(p^2): c_k -> c_k gamma_k conj(gamma_k), an Fp factor delta_k
    (delta_0 = 1)."""
    cs = _coeffs(a)
    return _from_coeffs([cs[0]] + [mul2_fp(c, cs[k], delta[k]) for k in range(1, 6)])


# -- state names -------------------------------------------------------------


def fp12_names(prefix: str):
    """The twelve Fp names of an Fp12 state in flatten12 order
    (coefficient 6 i + 2 j + k is a[i][j][k])."""
    return [f"{prefix}{i}" for i in range(12)]


def fp12_in(c, prefix):
    n = [c.inp(x) for x in fp12_names(prefix)]
    return tuple(tuple((n[6 * i + 2 * j], n[6 * i + 2 * j + 1]) for j in range(3))
                 for i in range(2))


def fp12_flat(a):
    return [x for half in a for pair in half for x in pair]


def fp12_out(c, prefix, a):
    for name, node in zip(fp12_names(prefix), fp12_flat(a)):
        c.output(name, node)


def fp2_in(c, prefix):
    return (c.inp(prefix + "0"), c.inp(prefix + "1"))


def fp2_out(c, prefix, a):
    c.output(prefix + "0", a[0])
    c.output(prefix + "1", a[1])


# -- the Miller loop's subroutines ------------------------------------------

MILLER_INPUTS = ["px", "py", "pz", "qx0", "qx1", "qy0", "qy1", "qz0", "qz1"]
MILLER_SUBS = ("affine", "dbl", "add", "final")


def miller_affine():
    """The affine points (g1_to_affine, g2_to_affine), T = (xq, yq, 1) and
    f = 1: two inversions side by side."""
    c = Code("affine")
    X1, Y1, Z1 = c.inp("px"), c.inp("py"), c.inp("pz")
    X2, Y2, Z2 = fp2_in(c, "qx"), fp2_in(c, "qy"), fp2_in(c, "qz")
    one = c.inp("one")
    zi = c.inv(Z1)
    zi2 = c.mul(zi, zi)
    xp, yp = c.mul(X1, zi2), c.mul(c.mul(Y1, zi), zi2)
    wi = inv2(c, Z2)
    wi2 = sqr2(c, wi)
    xq, yq = mul2(c, X2, wi2), mul2(c, mul2(c, Y2, wi), wi2)
    c.output("xp", xp)
    c.output("yp", yp)
    fp2_out(c, "xq", xq)
    fp2_out(c, "yq", yq)
    fp2_out(c, "tx", xq)
    fp2_out(c, "ty", yq)
    fp2_out(c, "tz", (one, c.zero()))
    z = zero2(c)
    fp12_out(c, "f", (((one, z[0]), z, z), (z, z, z)))
    return c


def miller_dbl():
    """f = f^2 times the tangent line at T, T = 2T: the polynomials of
    pairing_ops._dbl_step in three levels (T's degree-6 coordinates from
    the degree-2 and degree-4 products of X, Y, Z), with f^2 in the first
    and the sparse line product in the last."""
    c = Code("dbl")
    f = fp12_in(c, "f")
    X, Y, Z = fp2_in(c, "tx"), fp2_in(c, "ty"), fp2_in(c, "tz")
    xp, yp = c.inp("xp"), c.inp("yp")
    f2 = sqr12(c, f)
    X2, Y2 = sqr2(c, X), sqr2(c, Y)
    YZ, XY = mul2(c, Y, Z), mul2(c, X, Y)
    Zxp, Zyp = mul2_fp(c, Z, xp), mul2_fp(c, Z, yp)
    X3p = mul2(c, X2, X)  # X^3
    Y2Z = mul2(c, Y2, Z)  # Y^2 Z
    YZ2 = mul2(c, YZ, Z)  # Y Z^2
    X4 = sqr2(c, X2)  # X^4
    XY2Z = mul2(c, XY, YZ)  # X Y^2 Z
    lx = mul2(c, X2, Zxp)  # X^2 Z xp
    ly = mul2(c, YZ, Zyp)  # Y Z^2 yp
    Xn = mul2(c, scale2(c, YZ, 2), sub2(c, scale2(c, X4, 9), scale2(c, XY2Z, 8)))
    X3Y2Z, X6, Y4Z2 = mul2(c, X3p, Y2Z), sqr2(c, X3p), sqr2(c, Y2Z)
    Yn = tuple(c.lin([(36, a), (-27, b), (-8, d)]) for a, b, d in zip(X3Y2Z, X6, Y4Z2))
    Zn = scale2(c, mul2(c, Y2Z, YZ2), 8)
    l0 = sub2(c, scale2(c, X3p, 3), scale2(c, Y2Z, 2))
    l2 = scale2(c, lx, -3)
    l3 = scale2(c, ly, 2)
    fp12_out(c, "f", mul12_line(c, f2, l0, l2, l3))
    fp2_out(c, "tx", Xn)
    fp2_out(c, "ty", Yn)
    fp2_out(c, "tz", Zn)
    return c


def miller_add():
    """f = f times the line through T and Q, T = T + Q: the polynomials of
    pairing_ops._add_step (N = Y - yq Z, D = X - xq Z) from products of
    degree 2 in N, D, X, Z."""
    c = Code("add")
    f = fp12_in(c, "f")
    X, Y, Z = fp2_in(c, "tx"), fp2_in(c, "ty"), fp2_in(c, "tz")
    xq, yq = fp2_in(c, "xq"), fp2_in(c, "yq")
    xp, yp = c.inp("xp"), c.inp("yp")
    xqZ, yqZ = mul2(c, xq, Z), mul2(c, yq, Z)
    N, D = sub2(c, Y, yqZ), sub2(c, X, xqZ)
    N2, D2 = sqr2(c, N), sqr2(c, D)
    DN, NZ, DX, DZ = mul2(c, D, N), mul2(c, N, Z), mul2(c, D, X), mul2(c, D, Z)
    DxqZ, DyqZ = mul2(c, D, xqZ), mul2(c, D, yqZ)
    Nxq, yqD = mul2(c, N, xq), mul2(c, yq, D)
    # X3 = D N^2 Z - D^3 X - xq D^3 Z
    Xn = sub2(c, mul2(c, DN, NZ), mul2(c, D2, add2(c, DX, DxqZ)))
    # Y3 = N (2 xq D^2 Z + D^2 X - N^2 Z) - yq D^3 Z
    Yn = sub2(c, sub2(c, mul2(c, DN, add2(c, scale2(c, DxqZ, 2), DX)), mul2(c, N2, NZ)),
              mul2(c, D2, DyqZ))
    Zn = mul2(c, D2, DZ)  # D^3 Z
    l0 = sub2(c, Nxq, yqD)
    l2 = neg2(c, mul2_fp(c, N, xp))
    l3 = mul2_fp(c, D, yp)
    fp12_out(c, "f", mul12_line(c, f, l0, l2, l3))
    fp2_out(c, "tx", Xn)
    fp2_out(c, "ty", Yn)
    fp2_out(c, "tz", Zn)
    return c


def miller_final():
    """The conjugation for x < 0, into the output slots."""
    c = Code("final")
    fp12_out(c, "out", conj12(c, fp12_in(c, "f")))
    return c


# -- the final exponentiation's subroutines ----------------------------------

FE_SUBS = ("mulacc", "easy", "cyc0", "cyc", "mulb", "g1", "g2", "g3", "g5")


def _gamma_in(c):
    return [(c.inp(f"gamma{k}_0"), c.inp(f"gamma{k}_1")) for k in range(6)]


def _delta_in(c):
    return [None] + [c.inp(f"delta{k}") for k in range(1, 6)]


def fe_mulacc():
    c = Code("mulacc")
    fp12_out(c, "acc", mul12(c, fp12_in(c, "acc"), fp12_in(c, "fin")))
    return c


def fe_easy():
    """m = t^(p^2 + 1), t = conj(acc) / acc, into M and BASE; and
    delta_k = gamma_k conj(gamma_k) for the Frobenius maps by p^2."""
    c = Code("easy")
    a = fp12_in(c, "acc")
    gamma = _gamma_in(c)
    delta = [None] + [c.add(c.mul(g[0], g[0]), c.mul(g[1], g[1])) for g in gamma[1:]]
    t = mul12(c, conj12(c, a), inv12(c, a))
    m = mul12(c, frob12_2(c, t, delta), t)
    fp12_out(c, "m", m)
    fp12_out(c, "base", m)
    for k in range(1, 6):
        c.output(f"delta{k}", delta[k])
    return c


def fe_cyc0():
    c = Code("cyc0")
    fp12_out(c, "r", cyc_sqr12(c, fp12_in(c, "base")))
    return c


def fe_cyc():
    c = Code("cyc")
    fp12_out(c, "r", cyc_sqr12(c, fp12_in(c, "r")))
    return c


def fe_mulb():
    c = Code("mulb")
    fp12_out(c, "r", mul12(c, fp12_in(c, "r"), fp12_in(c, "base")))
    return c


def fe_g1():
    """BASE = conj(R)."""
    c = Code("g1")
    fp12_out(c, "base", conj12(c, fp12_in(c, "r")))
    return c


def fe_g2():
    """BM = BASE = conj(R): bm = m^((x - 1)^2)."""
    c = Code("g2")
    v = conj12(c, fp12_in(c, "r"))
    fp12_out(c, "bm", v)
    fp12_out(c, "base", v)
    return c


def fe_g3():
    """C = BASE = conj(R) frob(BM): c = bm^(x + p)."""
    c = Code("g3")
    v = mul12(c, conj12(c, fp12_in(c, "r")), frob12(c, fp12_in(c, "bm"), _gamma_in(c)))
    fp12_out(c, "c", v)
    fp12_out(c, "base", v)
    return c


def fe_g5():
    """OUT = conj(R) frob2(C) conj(C) cyc_sqr(M) M: c^(x^2 + p^2 - 1) m^3."""
    c = Code("g5")
    r, cc, m = fp12_in(c, "r"), fp12_in(c, "c"), fp12_in(c, "m")
    g = mul12(c, conj12(c, r), frob12_2(c, cc, _delta_in(c)))
    g = mul12(c, g, conj12(c, cc))
    h = mul12(c, cyc_sqr12(c, m), m)
    fp12_out(c, "out", mul12(c, g, h))
    return c


# -- scheduling ----------------------------------------------------------------


@dataclass
class Phase:
    kind: int
    entries: list  # MUL: (a, b, o); INV: (a, o); LIN: (o, [(slot, coef)])


@dataclass
class Sub:
    name: str
    phases: list
    levels: int  # MUL and INV phases
    waves: int  # LIN phases
    products: int
    temps: int  # temporary slots it needs


def _expand(code: Code):
    """Inline each linear node's linear terms while the entry keeps at
    most LIN_CAP terms (each one pass of independent multiply-adds over
    the words; the reduction is the same for every entry); returns
    {lin node: {node: coef}}."""
    exp = {}
    for n, kind in enumerate(code.kind):
        if kind != "lin":
            continue
        acc = {}
        for v, k in code.args[n].items():
            if code.kind[v] == "lin":
                cand = dict(acc)
                for w, j in exp[v].items():
                    cand[w] = cand.get(w, 0) + k * j
                cand = {w: j for w, j in cand.items() if j}
                if (len(cand) <= LIN_CAP and all(abs(j) < COEF_MAX for j in cand.values())
                        and sum(abs(j) for j in cand.values()) < COEF_SUM_MAX):
                    acc = cand
                    continue
            acc[v] = acc.get(v, 0) + k
            acc = {w: j for w, j in acc.items() if j}
        exp[n] = acc
    return exp


def schedule(code: Code, state: dict) -> Sub:
    """Phases of one subroutine; `state` maps state names to their slots,
    and temporaries take slots from len(state) up."""
    exp = _expand(code)
    kind = list(code.kind)
    terms = {n: dict(t) for n, t in exp.items()}

    def resolve(v):
        # a linear node that is one term with coefficient one is that term
        while kind[v] == "lin" and len(terms[v]) == 1 and next(iter(terms[v].values())) == 1:
            v = next(iter(terms[v]))
        return v

    def operands(n):
        if kind[n] == "mul":
            return [resolve(a) for a in code.args[n]]
        if kind[n] == "inv":
            return [resolve(code.args[n][0])]
        if kind[n] == "lin":
            return [resolve(v) for v in terms[n]]
        return []

    for n in terms:  # re-key linear terms by their resolved nodes
        acc = {}
        for v, k in terms[n].items():
            w = resolve(v)
            acc[w] = acc.get(w, 0) + k
        terms[n] = {w: k for w, k in acc.items() if k}

    # the live nodes, from the outputs back
    outputs = [(name, resolve(v)) for name, v in code.outputs]
    live, stack = set(), [v for _, v in outputs]
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(operands(n))
    users = {n: [] for n in live}
    for n in live:
        for o in operands(n):
            users[o].append(n)

    # heights: product levels from a node to the end
    height = {}
    for n in sorted(live, reverse=True):
        h = max((height[u] for u in users[n]), default=0)
        height[n] = h + (1 if kind[n] in ("mul", "inv") else 0)

    # list scheduling of the products and inversions into levels
    level, stage = {}, {}

    def ready_at(v):  # the level after which v exists, or None
        if kind[v] == "in":
            return 0
        if kind[v] in ("mul", "inv"):
            return level.get(v)
        if v not in stage:
            deps = [ready_at(o) for o in operands(v)]
            if any(d is None for d in deps):
                return None
            stage[v] = max(deps, default=0)
        return stage[v]

    pending = sorted(n for n in live if kind[n] in ("mul", "inv"))
    level_kinds = []
    while pending:
        lv = len(level_kinds) + 1
        ready = [n for n in pending
                 if all(r is not None and r < lv for r in (ready_at(o) for o in operands(n)))]
        muls = [n for n in ready if kind[n] == "mul"]
        if muls:
            muls.sort(key=lambda n: (-height[n], n))
            take, lk = muls[:GROUPS], MUL
        else:
            invs = [n for n in ready if kind[n] == "inv"]
            if not invs:
                raise RuntimeError(f"{code.name}: nothing ready at level {lv}")
            take, lk = invs[:INV_MAX], INV
        for n in take:
            level[n] = lv
        level_kinds.append(lk)
        taken = set(take)
        pending = [n for n in pending if n not in taken]
    for n in live:
        if kind[n] == "lin":
            ready_at(n)

    # waves of the linear nodes inside each stage
    wave = {}
    for n in sorted(n for n in live if kind[n] == "lin"):
        wave[n] = 1 + max((wave[o] for o in operands(n)
                           if kind[o] == "lin" and stage[o] == stage[n]), default=-1)

    # outputs: a linear node writes its state slot; a second output of it
    # is a clone, and an output of a product, an inversion or an input is
    # a copy (a linear node of one term)
    claimed = {}
    out_nodes = []
    for name, v in outputs:
        if kind[v] == "in" and code.args[v] == name:
            continue  # the state keeps its value
        if kind[v] == "lin" and v not in claimed:
            claimed[v] = name
            out_nodes.append((name, v))
            continue
        n = len(kind)
        kind.append("lin")
        terms[n] = dict(terms[v]) if kind[v] == "lin" else {v: 1}
        stage[n] = stage[v] if kind[v] == "lin" else (level[v] if kind[v] != "in" else 0)
        wave[n] = wave[v] if kind[v] == "lin" else 0
        users[n] = []
        for o in operands(n):
            users[o].append(n)
        live.add(n)
        claimed[n] = name
        out_nodes.append((name, n))

    # phases in order: stage 0 waves, level 1, stage 1 waves, level 2, ...
    n_levels = len(level_kinds)
    n_waves = {}
    for n in live:
        if kind[n] == "lin":
            n_waves[stage[n]] = max(n_waves.get(stage[n], 0), wave[n] + 1)
    order = []  # (kind, [nodes])
    for s in range(n_levels + 1):
        for w in range(n_waves.get(s, 0)):
            nodes = sorted(n for n in live if kind[n] == "lin" and stage[n] == s and wave[n] == w)
            for i in range(0, len(nodes), THREADS):
                order.append((LIN, nodes[i : i + THREADS]))
        if s < n_levels:
            nodes = sorted(n for n in live if kind[n] in ("mul", "inv") and level[n] == s + 1)
            order.append((level_kinds[s], nodes))
    phase_of = {}
    for i, (_, nodes) in enumerate(order):
        for n in nodes:
            phase_of[n] = i
    last_use = {}
    for n in live:
        for u in users[n]:
            last_use[n] = max(last_use.get(n, -1), phase_of[u])

    # a state output is written in place when the old value's last read
    # comes before it, or comes in the same wave from the entry that writes
    # it (an entry reads its terms before it writes); else it is copied in
    # a last wave
    inputs = {code.args[n]: n for n in live if kind[n] == "in"}
    slot = {n: state[code.args[n]] for n in live if kind[n] == "in"}
    late = []
    for name, n in out_nodes:
        old = inputs.get(name)
        if old is None or last_use.get(old, -1) < phase_of[n]:
            slot[n] = state[name]
        elif (last_use[old] == phase_of[n]
              and [u for u in users[old] if phase_of[u] == phase_of[n]] == [n]):
            slot[n] = state[name]
        else:
            late.append((name, n))
    if late:
        copies = []
        for name, v in late:
            n = len(kind)
            kind.append("lin")
            terms[n] = {v: 1}
            live.add(n)
            users[n] = []
            users[v].append(n)
            slot[n] = state[name]
            copies.append(n)
        order.append((LIN, copies))
        for n in copies:
            phase_of[n] = len(order) - 1
        for name, v in late:
            last_use[v] = len(order) - 1

    # temporaries by a linear scan: a phase's outputs take slots freed
    # before it, so no phase writes a slot it reads
    base = len(state)
    free, top = [], base
    frees_at = {}
    for n, u in last_use.items():
        if n not in slot or slot[n] >= base:
            frees_at.setdefault(u, []).append(n)
    for i, (_, nodes) in enumerate(order):
        for n in nodes:
            if n in slot:
                continue
            if n not in last_use:
                raise RuntimeError(f"{code.name}: node {n} is computed but never used")
            if free:
                free.sort()
                slot[n] = free.pop(0)
            else:
                slot[n] = top
                top += 1
        for n in frees_at.get(i, []):
            if n in slot and slot[n] >= base:
                free.append(slot[n])

    phases = []
    for lk, nodes in order:
        if lk == MUL:
            ents = [(slot[operands(n)[0]], slot[operands(n)[1]], slot[n]) for n in nodes]
        elif lk == INV:
            ents = [(slot[operands(n)[0]], slot[n]) for n in nodes]
        else:
            ents = [(slot[n], sorted((slot[v], k) for v, k in terms[n].items())) for n in nodes]
        phases.append(Phase(lk, ents))
    return Sub(code.name, phases,
               levels=sum(1 for p in phases if p.kind != LIN),
               waves=sum(1 for p in phases if p.kind == LIN),
               products=sum(len(p.entries) for p in phases if p.kind == MUL),
               temps=top - base)


# -- programs ------------------------------------------------------------------


def _state_layout(io_names, codes):
    names = list(io_names)
    for c in codes:
        for n, k in enumerate(c.kind):
            if k == "in" and c.args[n] not in names:
                names.append(c.args[n])
        for name, _ in c.outputs:
            if name not in names:
                names.append(name)
    return {name: i for i, name in enumerate(names)}


@dataclass
class Program:
    name: str
    subs: list
    io: list  # the slots of the kernel's loads and stores, in its order
    slots: int
    state: dict  # state name -> slot; the slots above them are temporaries
    words: list  # the encoded program, int32

    def sub(self, name: str) -> int:
        return [s.name for s in self.subs].index(name)


def _encode(subs, io, slots) -> list:
    if len(subs) > MAX_SUBS or len(io) > IO_LEN:
        raise ValueError("program header overflow")
    words = [0] * HEADER
    words[H_SLOTS] = slots
    words[H_IO : H_IO + len(io)] = io
    table, body = [], []
    n_phases = sum(len(s.phases) for s in subs)
    body_at = HEADER + 4 * n_phases
    first = 0
    for i, s in enumerate(subs):
        words[H_SUBS + 2 * i] = first
        words[H_SUBS + 2 * i + 1] = len(s.phases)
        first += len(s.phases)
        for ph in s.phases:
            off = body_at + len(body)
            if ph.kind == MUL:
                if len(ph.entries) > GROUPS:
                    raise ValueError("a level holds at most 56 products")
                body += [a | b << 10 | o << 20 for a, b, o in ph.entries]
                stride = 1
            elif ph.kind == INV:
                if len(ph.entries) > INV_MAX:
                    raise ValueError("an inversion phase holds at most 7 entries")
                body += [a | o << 10 for a, o in ph.entries]
                stride = 1
            else:
                if len(ph.entries) > THREADS:
                    raise ValueError("a wave holds at most 224 entries")
                stride = 1 + max(len(t) for _, t in ph.entries)
                for o, ts in ph.entries:
                    if sum(abs(k) for _, k in ts) >= COEF_SUM_MAX or any(
                            abs(k) >= COEF_MAX for _, k in ts):
                        raise ValueError("a linear entry's coefficients overflow the kernel's sums")
                    ent = [o | len(ts) << 16]
                    ent += [s | (k & 0xFFFF) << 16 for s, k in ts]
                    body += ent + [0] * (stride - len(ent))
            table += [ph.kind, len(ph.entries), off, stride]
    words[H_TABLE] = HEADER
    words += table + body
    if slots >= 1 << 10:
        raise ValueError("slot indices take 10 bits")
    return [w - (1 << 32) if w >= 1 << 31 else w for w in words]


def _program(name, io_names, codes):
    state = _state_layout(io_names, codes)
    subs = [schedule(c, state) for c in codes]
    slots = len(state) + max(s.temps for s in subs)
    io = [state[n] for n in io_names]
    return Program(name, subs, io, slots, state, _encode(subs, io, slots))


def miller_program() -> Program:
    """Subroutines affine, dbl, add, final. io: the nine input slots
    (px, py, pz, qx0, qx1, qy0, qy1, qz0, qz1), the slot of one, the
    twelve output slots."""
    io_names = MILLER_INPUTS + ["one"] + fp12_names("out")
    return _program("miller", io_names,
                    [miller_affine(), miller_dbl(), miller_add(), miller_final()])


def final_exp_program() -> Program:
    """Subroutines as FE_SUBS. io: acc (12), fin (12), gamma_k (k < 6,
    two each), one, out (12)."""
    io_names = (fp12_names("acc") + fp12_names("fin")
                + [f"gamma{k}_{i}" for k in range(6) for i in range(2)] + ["one"]
                + fp12_names("out"))
    codes = [fe_mulacc(), fe_easy(), fe_cyc0(), fe_cyc(), fe_mulb(), fe_g1(), fe_g2(), fe_g3(),
             fe_g5()]
    return _program("final_exp", io_names, codes)


@functools.cache
def programs():
    """(miller_program, final_exp_program), built once."""
    return miller_program(), final_exp_program()


def pow_calls(e: int):
    """The subroutines a power by e runs: cyc0 for the first bit below the
    top, cyc for the rest, and mulb after each set bit (the kernel's
    loop)."""
    calls = []
    top = e.bit_length() - 1
    for i in range(top - 1, -1, -1):
        calls.append("cyc0" if i == top - 1 else "cyc")
        if (e >> i) & 1:
            calls.append("mulb")
    return calls


def final_exp_calls(lanes: int):
    calls = ["mulacc"] * (lanes - 1) + ["easy"]
    calls += pow_calls(XM1_ABS) + ["g1"] + pow_calls(XM1_ABS) + ["g2"]
    calls += pow_calls(X_ABS) + ["g3"] + pow_calls(X_ABS) + ["g1"] + pow_calls(X_ABS) + ["g5"]
    return calls


def miller_calls():
    calls = ["affine"]
    for bit in bin(X_ABS)[3:]:
        calls.append("dbl")
        if bit == "1":
            calls.append("add")
    return calls + ["final"]


def count(prog: Program, calls) -> dict:
    """Levels, waves and products of a kernel's run of these calls."""
    out = {"levels": 0, "waves": 0, "products": 0, "inversions": 0}
    for name in calls:
        s = prog.subs[prog.sub(name)]
        out["levels"] += s.levels
        out["waves"] += s.waves
        out["products"] += s.products
        out["inversions"] += sum(len(p.entries) for p in s.phases if p.kind == INV)
    return out


# -- the emulator ------------------------------------------------------------


def run_sub(prog: Program, name: str, mem: list) -> None:
    """One subroutine on plain field values, phase by phase as the kernel
    runs it. Temporaries hold nothing at the start; a phase that reads a
    slot it (or another entry) writes, or reads a slot that holds
    nothing, raises."""
    sub = prog.subs[prog.sub(name)]
    for s in range(len(prog.state), prog.slots):
        mem[s] = None
    for ph in sub.phases:
        if ph.kind == MUL:
            reads = [[a, b] for a, b, _ in ph.entries]
            writes = [o for _, _, o in ph.entries]
        elif ph.kind == INV:
            reads = [[a] for a, _ in ph.entries]
            writes = [o for _, o in ph.entries]
        else:
            reads = [[s for s, _ in ts] for _, ts in ph.entries]
            writes = [o for o, _ in ph.entries]
        for i, o in enumerate(writes):  # only a linear entry may read its own output slot
            others = {s for j, r in enumerate(reads) for s in r if j != i or ph.kind != LIN}
            if o in others:
                raise AssertionError(f"{name}: a phase writes a slot another entry reads")
        reads = [s for r in reads for s in r]
        if len(set(writes)) != len(writes):
            raise AssertionError(f"{name}: two entries of a phase write one slot")
        if any(mem[s] is None for s in reads):
            raise AssertionError(f"{name}: a phase reads an empty slot")
        if ph.kind == MUL:
            vals = [mem[a] * mem[b] % P for a, b, _ in ph.entries]
        elif ph.kind == INV:
            vals = [pow(mem[a], P - 2, P) for a, _ in ph.entries]
        else:
            vals = [sum(k * mem[s] for s, k in ts) % P for _, ts in ph.entries]
        for o, v in zip(writes, vals):
            mem[o] = v


def emulate_miller_loop(prog: Program, p_jac, q_jac):
    """One pair as pairing_miller_loop runs it, on plain values: G1
    Jacobian (X, Y, Z) ints and G2 Jacobian ((x0, x1), ...) -> the twelve
    Fp coefficients of the conjugated Miller value (flatten12 order),
    one for a member at infinity."""
    one = [1] + [0] * 11
    if p_jac[2] % P == 0 or (q_jac[2][0] % P == 0 and q_jac[2][1] % P == 0):
        return one
    mem = [None] * prog.slots
    values = [p_jac[0], p_jac[1], p_jac[2]] + [q_jac[i][j] for i in range(3) for j in range(2)]
    for s, v in zip(prog.io[:9], values):
        mem[s] = v % P
    mem[prog.io[9]] = 1
    for name in miller_calls():
        run_sub(prog, name, mem)
    return [mem[s] for s in prog.io[10:22]]


def emulate_final_exp(prog: Program, fs):
    """Lists of twelve Fp coefficients (B >= 1 lanes) -> (the twelve
    coefficients of FE(prod f)^3, == 1), as pairing_final_exp runs it."""
    from ..host import field as HF

    mem = [None] * prog.slots
    io = prog.io
    for s, v in zip(io[0:12], fs[0]):
        mem[s] = v % P
    for k in range(6):
        for i in range(2):
            mem[io[24 + 2 * k + i]] = HF.FROBENIUS_GAMMA[k][i]
    mem[io[36]] = 1
    calls = final_exp_calls(len(fs))
    lane = 1
    for name in calls:
        if name == "mulacc":
            for s, v in zip(io[12:24], fs[lane]):
                mem[s] = v % P
            lane += 1
        run_sub(prog, name, mem)
    out = [mem[s] for s in io[37:49]]
    return out, out == [1] + [0] * 11
