// BLS12-381 G1 group law on fp.cuh, shared by the point kernels (g1.cu) and
// the MSM kernels (msm.cu). Jacobian (X, Y, Z), Montgomery form, infinity
// is Z == 0. The formulas run in the order of ops/formulas.py and the
// exceptional lanes are resolved in the precedence of the plain versions
// (ops/g1_ops.py), so every result equals them limb for limb, Z included.
#pragma once
#include <stdint.h>

#include "fp.cuh"

namespace g1 {

using fp::Fp;

struct Jac {
  Fp X, Y, Z;
};

// [3, 12, M] limbs-first: coordinate c, limb k of lane m at (c*12 + k)*M + m
__device__ __forceinline__ Jac load_jac(const uint32_t* __restrict__ p, int M,
                                        int m) {
  Jac r;
  r.X = fp::load(p, M, m);
  r.Y = fp::load(p + (size_t)fp::NL * M, M, m);
  r.Z = fp::load(p + (size_t)2 * fp::NL * M, M, m);
  return r;
}

__device__ __forceinline__ void store_jac(uint32_t* __restrict__ out, int M,
                                          int m, const Jac& r) {
  fp::store(out, M, m, r.X);
  fp::store(out + (size_t)fp::NL * M, M, m, r.Y);
  fp::store(out + (size_t)2 * fp::NL * M, M, m, r.Z);
}

__device__ __forceinline__ Jac jac_zero() {
  Jac r;
  r.X = fp::zero();
  r.Y = fp::zero();
  r.Z = fp::zero();
  return r;
}

// dbl-2009-l (a = 0); Z = 0 stays Z = 0
__device__ __forceinline__ Jac jac_dbl(const Jac& p) {
  using namespace fp;
  const Fp XX = sqr(p.X);
  const Fp YY = sqr(p.Y);
  const Fp YYYY = sqr(YY);
  const Fp ZZ = sqr(p.Z);
  Fp S = sub(sub(sqr(add(p.X, YY)), XX), YYYY);
  S = add(S, S);
  const Fp M = add(add(XX, XX), XX);
  const Fp T = sub(sqr(M), add(S, S));
  const Fp Y8 = dbl(dbl(dbl(YYYY)));
  Jac r;
  r.X = T;
  r.Y = sub(mul(M, sub(S, T)), Y8);
  r.Z = sub(sub(sqr(add(p.Y, p.Z)), YY), ZZ);
  return r;
}

// add-2007-bl with the same-x fixups; p or q at infinity handled by caller
__device__ __forceinline__ Jac jac_add_finite(const Jac& p, const Jac& q) {
  using namespace fp;
  const Fp Z1Z1 = sqr(p.Z);
  const Fp Z2Z2 = sqr(q.Z);
  const Fp U1 = mul(p.X, Z2Z2);
  const Fp U2 = mul(q.X, Z1Z1);
  const Fp S1 = mul(mul(p.Y, q.Z), Z2Z2);
  const Fp S2 = mul(mul(q.Y, p.Z), Z1Z1);
  const Fp H = sub(U2, U1);
  const Fp Rr = sub(S2, S1);
  if (is_zero(H)) {
    return is_zero(Rr) ? jac_dbl(p) : jac_zero();
  }
  const Fp HH = sqr(H);
  const Fp I = dbl(dbl(HH));
  const Fp J = mul(H, I);
  const Fp r2 = add(Rr, Rr);
  const Fp V = mul(U1, I);
  Jac r;
  r.X = sub(sub(sqr(r2), J), add(V, V));
  const Fp S1J = mul(S1, J);
  r.Y = sub(mul(r2, sub(V, r.X)), add(S1J, S1J));
  r.Z = mul(sub(sub(sqr(add(p.Z, q.Z)), Z1Z1), Z2Z2), H);
  return r;
}

// complete p + q: q at infinity gives p, then p at infinity gives q
__device__ __forceinline__ Jac jac_add(const Jac& p, const Jac& q) {
  if (fp::is_zero(q.Z)) return p;
  if (fp::is_zero(p.Z)) return q;
  return jac_add_finite(p, q);
}

// madd-2007-bl with the same-x fixups; p at infinity handled by caller
__device__ __forceinline__ Jac jac_madd_finite(const Jac& p, const Fp& X2,
                                               const Fp& Y2) {
  using namespace fp;
  const Fp Z1Z1 = sqr(p.Z);
  const Fp U2 = mul(X2, Z1Z1);
  const Fp S2 = mul(mul(Y2, p.Z), Z1Z1);
  const Fp H = sub(U2, p.X);
  const Fp Rr = sub(S2, p.Y);
  if (is_zero(H)) {
    return is_zero(Rr) ? jac_dbl(p) : jac_zero();
  }
  const Fp HH = sqr(H);
  const Fp I = dbl(dbl(HH));
  const Fp J = mul(H, I);
  const Fp r2 = add(Rr, Rr);
  const Fp V = mul(p.X, I);
  Jac r;
  r.X = sub(sub(sqr(r2), J), add(V, V));
  const Fp Y1J = mul(p.Y, J);
  r.Y = sub(mul(r2, sub(V, r.X)), add(Y1J, Y1J));
  r.Z = sub(sub(sqr(add(p.Z, H)), Z1Z1), HH);
  return r;
}

// p + affine (X2, Y2) on a live lane: an empty bucket lifts q with Z = 1
__device__ __forceinline__ Jac jac_madd(const Jac& p, const Fp& X2,
                                        const Fp& Y2) {
  if (fp::is_zero(p.Z)) {
    Jac r;
    r.X = X2;
    r.Y = Y2;
    r.Z = fp::one();
    return r;
  }
  return jac_madd_finite(p, X2, Y2);
}

}  // namespace g1
