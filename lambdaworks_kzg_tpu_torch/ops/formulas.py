"""Short-Weierstrass Jacobian group law for a = 0, field-agnostic.

dbl-2009-l / add-2007-bl / madd-2007-bl, in the same operation order as
the JAX package's `ops/formulas.py`; the CUDA kernels (`csrc/g1.cu`)
follow the same order. `f` supplies mul/sqr/add/sub/double. The cores
also return H and Rr so callers can patch the same-x lanes (H == 0):
doubling when Rr == 0, infinity otherwise.
"""


def jacobian_dbl(f, X, Y, Z):
    """(X, Y, Z) -> 2 (X, Y, Z). Z = 0 stays Z = 0."""
    XX = f.sqr(X)
    YY = f.sqr(Y)
    YYYY = f.sqr(YY)
    ZZ = f.sqr(Z)
    S = f.sub(f.sub(f.sqr(f.add(X, YY)), XX), YYYY)
    S = f.add(S, S)
    M = f.add(f.add(XX, XX), XX)
    T = f.sub(f.sqr(M), f.add(S, S))
    Y8 = f.double(f.double(f.double(YYYY)))
    Y3 = f.sub(f.mul(M, f.sub(S, T)), Y8)
    Z3 = f.sub(f.sub(f.sqr(f.add(Y, Z)), YY), ZZ)
    return T, Y3, Z3


def jacobian_add_core(f, X1, Y1, Z1, X2, Y2, Z2):
    """Jacobian + Jacobian -> (X3, Y3, Z3, H, Rr); junk on lanes where
    either input is infinity or the x coordinates agree."""
    Z1Z1 = f.sqr(Z1)
    Z2Z2 = f.sqr(Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, U1)
    Rr = f.sub(S2, S1)
    HH = f.sqr(H)
    I = f.double(f.double(HH))
    J = f.mul(H, I)
    r2 = f.add(Rr, Rr)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.sqr(r2), J), f.add(V, V))
    S1J = f.mul(S1, J)
    Y3 = f.sub(f.mul(r2, f.sub(V, X3)), f.add(S1J, S1J))
    Z3 = f.mul(f.sub(f.sub(f.sqr(f.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return X3, Y3, Z3, H, Rr


def jacobian_madd_core(f, X1, Y1, Z1, X2, Y2):
    """Jacobian + affine (Z2 = 1) -> (X3, Y3, Z3, H, Rr)."""
    Z1Z1 = f.sqr(Z1)
    U2 = f.mul(X2, Z1Z1)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, X1)
    Rr = f.sub(S2, Y1)
    HH = f.sqr(H)
    I = f.double(f.double(HH))
    J = f.mul(H, I)
    r2 = f.add(Rr, Rr)
    V = f.mul(X1, I)
    X3 = f.sub(f.sub(f.sqr(r2), J), f.add(V, V))
    Y1J = f.mul(Y1, J)
    Y3 = f.sub(f.mul(r2, f.sub(V, X3)), f.add(Y1J, Y1J))
    Z3 = f.sub(f.sub(f.sqr(f.add(Z1, H)), Z1Z1), HH)
    return X3, Y3, Z3, H, Rr
