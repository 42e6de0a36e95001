// The BLS12-381 G1 group law on the cooperative field (fp_coop.cuh), shared
// by the batched G1 kernels (g1_batch.cu) and the MSM's reduce and combine
// (msm.cu):
// g1.cuh's formulas, values and exceptional lanes, so every result equals
// the plain versions (ops/g1_ops.py) limb for limb, Z included. A point
// op runs on a pair of groups (8 threads), both holding the operands, with
// its products two at a time (fpc::mul2), or for the combine on a unit of
// four groups (cjac_dbl4, cjac_add4). Every thread of a warp runs
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

// -- a unit of four groups (16 threads): up to four field ops at once --------
//
// The same group law with each step's independent field ops spread over
// four groups, all four holding the operands: the doubling is 3 products
// and 6 sums deep, the add 5 products and 5 sums, against 4 and 8
// products (and 12 and 15 sums) on a pair. Every op returns the fully
// reduced value, so a formula with the same field values gives the same
// words: the results, Z included, are cjac_dbl's and cjac_add's (live),
// and the plain versions stay the reference limb for limb.

// 0 .. 3: this thread's group in its unit
__device__ __forceinline__ int quad() { return (fpc::lane() / fpc::kT) & 3; }

// Every group of a unit holds x[i], y[i] (i < N <= 4); group g computes
// f(x[g], y[g]) (a group past N the first again), and after the exchange
// every group holds all N results. The shuffles name the whole warp, as
// fp_coop.cuh's do; width 16 keeps each unit in its half-warp.
template <int N, class F>
__device__ __forceinline__ void spread4(F f, const Fq (&x)[N], const Fq (&y)[N], Fq (&r)[N]) {
  static_assert(N >= 1 && N <= 4, "a unit runs up to four ops");
  const int g = quad();
  Fq a = x[0], b = y[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    a = fpc::sel(g == i, x[i], a);
    b = fpc::sel(g == i, y[i], b);
  }
  const Fq mine = f(a, b);
  if constexpr (N == 1) {
    r[0] = mine;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < fpc::kS; ++k)
        r[i].v[k] = __shfl_sync(fpc::kWarp, mine.v[k], i * fpc::kT + fpc::rank(), 4 * fpc::kT);
    }
  }
}

template <int N>
__device__ __forceinline__ void mul4(const Fq (&x)[N], const Fq (&y)[N], Fq (&r)[N]) {
  spread4([](const Fq& a, const Fq& b) { return fpc::mul(a, b); }, x, y, r);
}

template <int N>
__device__ __forceinline__ void add4(const Fq (&x)[N], const Fq (&y)[N], Fq (&r)[N]) {
  spread4([](const Fq& a, const Fq& b) { return fpc::add(a, b); }, x, y, r);
}

template <int N>
__device__ __forceinline__ void sub4(const Fq (&x)[N], const Fq (&y)[N], Fq (&r)[N]) {
  spread4([](const Fq& a, const Fq& b) { return fpc::sub(a, b); }, x, y, r);
}

// dbl-2009-l (a = 0): XX, YY, YZ; 2 XX, Z3 = 2 YZ, 2 YY, 2 X; M = 3 XX;
// MM, (2 YY)^2 = 4 YYYY, S = 2 X 2 YY = 4 X YY; 2 S, 8 YYYY; X3 = T = MM
// - 2 S; S - T; M (S - T); Y3 = M (S - T) - 8 YYYY. cjac_dbl's values.
__device__ __forceinline__ CJac cjac_dbl4(const CJac& p) {
  using namespace fpc;
  Fq l1[3], a1[4], l2[3], a2[2];
  {
    const Fq x[3] = {p.X, p.Y, p.Y}, y[3] = {p.X, p.Y, p.Z};
    mul4(x, y, l1);  // XX, YY, YZ
  }
  {
    const Fq x[4] = {l1[0], l1[2], l1[1], p.X}, y[4] = {l1[0], l1[2], l1[1], p.X};
    add4(x, y, a1);  // 2 XX, Z3, 2 YY, 2 X
  }
  const Fq M = add(a1[0], l1[0]);
  {
    const Fq x[3] = {M, a1[2], a1[3]}, y[3] = {M, a1[2], a1[2]};
    mul4(x, y, l2);  // MM, 4 YYYY, S
  }
  {
    const Fq x[2] = {l2[2], l2[1]}, y[2] = {l2[2], l2[1]};
    add4(x, y, a2);  // 2 S, 8 YYYY
  }
  CJac r;
  r.X = sub(l2[0], a2[0]);
  r.Y = sub(mul(M, sub(l2[2], r.X)), a2[1]);
  r.Z = a1[1];
  return r;
}

// complete p + q (add-2007-bl): Z1Z1, Z2Z2, Y1 Z2, Y2 Z1; U1, U2, S1, S2;
// H = U2 - U1, Rr = S2 - S1; r2 = 2 Rr, 2 H, U1 + U2, 2 S1; I = (2 H)^2,
// RR = r2^2, Z1 Z2; J = H I, V = U1 I, Z3 = Z1 Z2 2 H, J + 2 V = (U1 + U2)
// I; X3 = RR - (J + 2 V); r2 (V - X3), 2 S1 J; Y3. Then cjac_add's fixups
// in its order, the doubling only where a lane of the warp needs it.
// cjac_add's values.
__device__ __forceinline__ CJac cjac_add4(const CJac& p, const CJac& q) {
  using namespace fpc;
  const bool p_inf = is_zero(p.Z);
  const bool q_inf = is_zero(q.Z);
  Fq l1[4], l2[4], s1[2], a1[4], l3[3], l4[4], l5[2];
  {
    const Fq x[4] = {p.Z, q.Z, p.Y, q.Y}, y[4] = {p.Z, q.Z, q.Z, p.Z};
    mul4(x, y, l1);  // Z1Z1, Z2Z2, t1, t2
  }
  {
    const Fq x[4] = {p.X, q.X, l1[2], l1[3]}, y[4] = {l1[1], l1[0], l1[1], l1[0]};
    mul4(x, y, l2);  // U1, U2, S1, S2
  }
  {
    const Fq x[2] = {l2[1], l2[3]}, y[2] = {l2[0], l2[2]};
    sub4(x, y, s1);  // H, Rr
  }
  const Fq& H = s1[0];
  const bool h_zero = is_zero(H);  // a ballot: every thread, before any &&
  const bool same_x = !p_inf && !q_inf && h_zero;
  {
    const Fq x[4] = {s1[1], H, l2[0], l2[2]}, y[4] = {s1[1], H, l2[1], l2[2]};
    add4(x, y, a1);  // r2, 2 H, U1 + U2, 2 S1
  }
  {
    const Fq x[3] = {a1[1], a1[0], p.Z}, y[3] = {a1[1], a1[0], q.Z};
    mul4(x, y, l3);  // I, RR, Z1 Z2
  }
  {
    const Fq x[4] = {H, l2[0], l3[2], a1[2]}, y[4] = {l3[0], l3[0], a1[1], l3[0]};
    mul4(x, y, l4);  // J, V, Z3, J + 2 V
  }
  CJac r;
  r.X = sub(l3[1], l4[3]);
  {
    const Fq x[2] = {a1[0], a1[3]}, y[2] = {sub(l4[1], r.X), l4[0]};
    mul4(x, y, l5);  // r2 (V - X3), 2 S1 J
  }
  r.Y = sub(l5[0], l5[1]);
  r.Z = l4[2];
  if (warp_any(same_x)) {
    const bool r_zero = is_zero(s1[1]);
    r = csel(same_x && r_zero, cjac_dbl4(p), r);
    r = csel(same_x && !r_zero, cjac_zero(), r);
  }
  return csel(q_inf, p, csel(p_inf, q, r));
}

}  // namespace g1c
