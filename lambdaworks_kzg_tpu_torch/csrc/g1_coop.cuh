// The BLS12-381 G1 group law on the cooperative field (fp_coop.cuh), shared
// by the batched G1 kernels (g1_batch.cu) and the MSM's reduce (msm.cu):
// g1.cuh's formulas, values and exceptional lanes, so every result equals
// the plain versions (ops/g1_ops.py) limb for limb, Z included. A point
// op runs on a pair of groups (8 threads), both holding the operands, with
// its products two at a time (fpc::mul2). Every thread of a warp runs
// every field op: branches on one lane's data are selects, or branches on
// a warp-wide any.
#pragma once
#include <stdint.h>

#include "fp_coop.cuh"

namespace g1c {

using fpc::Fq;

struct CJac {
  Fq X, Y, Z;
};

__device__ __forceinline__ CJac load_cjac(const uint32_t* __restrict__ p, int M, int m) {
  CJac r;
  r.X = fpc::load(p, M, m);
  r.Y = fpc::load(p + (size_t)fp::NL * M, M, m);
  r.Z = fpc::load(p + (size_t)2 * fp::NL * M, M, m);
  return r;
}

__device__ __forceinline__ void store_cjac(uint32_t* __restrict__ out, int M, int m,
                                           const CJac& r) {
  fpc::store(out, M, m, r.X);
  fpc::store(out + (size_t)fp::NL * M, M, m, r.Y);
  fpc::store(out + (size_t)2 * fp::NL * M, M, m, r.Z);
}

__device__ __forceinline__ CJac cjac_zero() {
  CJac r;
  r.X = fpc::zero();
  r.Y = fpc::zero();
  r.Z = fpc::zero();
  return r;
}

// dbl-2009-l (a = 0) on a pair of groups, both holding p: the products
// run two at a time (fpc::mul2), 4 deep instead of 7. The values are the
// plain version's (formulas.py): S = 2((X + YY)^2 - XX - YYYY) = 4 X YY
// and Z3 = (Y + Z)^2 - YY - ZZ = 2 Y Z, fully reduced, so the limbs are
// too. Z = 0 stays Z = 0.
__device__ __forceinline__ CJac cjac_dbl(const CJac& p) {
  using namespace fpc;
  Fq XX, YY, MM, YYYY, YZ, XYY;
  mul2(p.X, p.X, p.Y, p.Y, XX, YY);
  const Fq M = add(add(XX, XX), XX);
  mul2(M, M, YY, YY, MM, YYYY);
  mul2(p.Y, p.Z, p.X, YY, YZ, XYY);
  const Fq S = dbl(dbl(XYY));
  const Fq T = sub(MM, add(S, S));
  const Fq Y8 = dbl(dbl(dbl(YYYY)));
  CJac r;
  r.X = T;
  r.Y = sub(mul(M, sub(S, T)), Y8);
  r.Z = dbl(YZ);
  return r;
}

__device__ __forceinline__ CJac csel(bool c, const CJac& a, const CJac& b) {
  CJac r;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    r.X.v[k] = c ? a.X.v[k] : b.X.v[k];
    r.Y.v[k] = c ? a.Y.v[k] : b.Y.v[k];
    r.Z.v[k] = c ? a.Z.v[k] : b.Z.v[k];
  }
  return r;
}

// complete p + q on a pair of groups, both holding p and q: add-2007-bl
// with its 16 products two at a time (8 deep), then the plain version's
// fixups in its precedence (same x: the doubling or infinity; q at
// infinity gives p, then p at infinity gives q) as selects, so every lane
// of the warp runs the same code; the doubling runs only where a lane of
// the warp needs it, and never for a lane whose sum is dropped (live false)
__device__ __forceinline__ CJac cjac_add(const CJac& p, const CJac& q, bool live = true) {
  using namespace fpc;
  const bool p_inf = is_zero(p.Z);
  const bool q_inf = is_zero(q.Z);
  Fq Z1Z1, Z2Z2, U1, U2, t1, t2, S1, S2;
  mul2(p.Z, p.Z, q.Z, q.Z, Z1Z1, Z2Z2);
  mul2(p.X, Z2Z2, q.X, Z1Z1, U1, U2);
  mul2(p.Y, q.Z, q.Y, p.Z, t1, t2);
  mul2(t1, Z2Z2, t2, Z1Z1, S1, S2);
  const Fq H = sub(U2, U1);
  const Fq Rr = sub(S2, S1);
  const bool h_zero = is_zero(H);  // a ballot: every thread, before any &&
  const bool same_x = live && !p_inf && !q_inf && h_zero;
  const Fq ZZ = add(p.Z, q.Z);
  Fq HH, ZZ2, J, V, RR, S1J, Y3, Z3;
  mul2(H, H, ZZ, ZZ, HH, ZZ2);
  const Fq I = dbl(dbl(HH));
  mul2(H, I, U1, I, J, V);
  const Fq r2 = add(Rr, Rr);
  mul2(r2, r2, S1, J, RR, S1J);
  CJac r;
  r.X = sub(sub(RR, J), add(V, V));
  mul2(r2, sub(V, r.X), sub(sub(ZZ2, Z1Z1), Z2Z2), H, Y3, Z3);
  r.Y = sub(Y3, add(S1J, S1J));
  r.Z = Z3;
  if (warp_any(same_x)) {
    const bool r_zero = is_zero(Rr);
    r = csel(same_x && r_zero, cjac_dbl(p), r);
    r = csel(same_x && !r_zero, cjac_zero(), r);
  }
  return csel(q_inf, p, csel(p_inf, q, r));
}

}  // namespace g1c
