// The BLS12-381 extension tower on fp.cuh, one thread per element, for the
// pairing kernels (pairing.cu):
//
//   Fp2  = Fp[u]  / (u^2 + 1)
//   Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
//   Fp12 = Fp6[w] / (w^2 - v)
//
// The formulas are the plain versions' (ops/fp2_ops.py, ops/tower_ops.py,
// which port the JAX package's ops/fp2_ops.py and ops/tower_ops.py), and
// every field result is fully reduced, so each value equals the plain
// version's limb for limb however the products are ordered.
//
// Build size: every product, square, inversion and Frobenius map is
// __noinline__, one shared copy each over the __noinline__ fp::mul and
// fp::sqr (inlined copies of fp::mul overflowed the instruction cache and
// stretched the build from 4.4 s to 65.1 s, PERF.md). Fp2 values pass in
// registers (24 words); Fp6 and Fp12 values live in local memory and pass
// by reference. A result may alias an operand: each function reads its
// operands into temporaries before it writes the result.
#pragma once
#include "fp.cuh"

namespace tower {

using fp::Fp;

struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};

// -- Fp2 --------------------------------------------------------------------

__device__ __forceinline__ Fp fp_neg(const Fp& a) { return fp::sub(fp::zero(), a); }

__device__ __forceinline__ Fp2 zero2() { return {fp::zero(), fp::zero()}; }
__device__ __forceinline__ Fp2 one2() { return {fp::one(), fp::zero()}; }

__device__ __forceinline__ Fp2 add2(const Fp2& a, const Fp2& b) {
  return {fp::add(a.c0, b.c0), fp::add(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 sub2(const Fp2& a, const Fp2& b) {
  return {fp::sub(a.c0, b.c0), fp::sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 neg2(const Fp2& a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }
__device__ __forceinline__ Fp2 dbl2(const Fp2& a) { return add2(a, a); }
__device__ __forceinline__ Fp2 conj2(const Fp2& a) { return {a.c0, fp_neg(a.c1)}; }
// a (1 + u)
__device__ __forceinline__ Fp2 mul_xi(const Fp2& a) {
  return {fp::sub(a.c0, a.c1), fp::add(a.c0, a.c1)};
}
__device__ __forceinline__ bool is_zero2(const Fp2& a) {
  return fp::is_zero(a.c0) && fp::is_zero(a.c1);
}

// Karatsuba: c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1
static __device__ __noinline__ Fp2 mul2(Fp2 a, Fp2 b) {
  const Fp t0 = fp::mul(a.c0, b.c0);
  const Fp t1 = fp::mul(a.c1, b.c1);
  const Fp s = fp::mul(fp::add(a.c0, a.c1), fp::add(b.c0, b.c1));
  return {fp::sub(t0, t1), fp::sub(fp::sub(s, t0), t1)};
}

// c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1
static __device__ __noinline__ Fp2 sqr2(Fp2 a) {
  const Fp m = fp::mul(a.c0, a.c1);
  return {fp::mul(fp::add(a.c0, a.c1), fp::sub(a.c0, a.c1)), fp::add(m, m)};
}

// a Fp2 value times an Fp value
static __device__ __noinline__ Fp2 mul2_fp(Fp2 a, Fp s) {
  return {fp::mul(a.c0, s), fp::mul(a.c1, s)};
}

// conj(a) / (a0^2 + a1^2); 0 -> 0
static __device__ __noinline__ Fp2 inv2(Fp2 a) {
  const Fp t = fp::inv(fp::add(fp::sqr(a.c0), fp::sqr(a.c1)));
  return {fp::mul(a.c0, t), fp_neg(fp::mul(a.c1, t))};
}

// -- Fp6 --------------------------------------------------------------------

__device__ __forceinline__ void add6(Fp6& r, const Fp6& a, const Fp6& b) {
  r.c0 = add2(a.c0, b.c0);
  r.c1 = add2(a.c1, b.c1);
  r.c2 = add2(a.c2, b.c2);
}
__device__ __forceinline__ void sub6(Fp6& r, const Fp6& a, const Fp6& b) {
  r.c0 = sub2(a.c0, b.c0);
  r.c1 = sub2(a.c1, b.c1);
  r.c2 = sub2(a.c2, b.c2);
}
__device__ __forceinline__ void neg6(Fp6& r, const Fp6& a) {
  r.c0 = neg2(a.c0);
  r.c1 = neg2(a.c1);
  r.c2 = neg2(a.c2);
}
// (a0 + a1 v + a2 v^2) v = xi a2 + a0 v + a1 v^2
__device__ __forceinline__ void mul_v(Fp6& r, const Fp6& a) {
  const Fp2 t = mul_xi(a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

// Toom/Karatsuba interpolation, six Fp2 products:
// c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
// c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
// c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1,   ti = ai bi
static __device__ __noinline__ void mul6(Fp6& r, const Fp6& a, const Fp6& b) {
  const Fp2 t0 = mul2(a.c0, b.c0);
  const Fp2 t1 = mul2(a.c1, b.c1);
  const Fp2 t2 = mul2(a.c2, b.c2);
  const Fp2 m12 = mul2(add2(a.c1, a.c2), add2(b.c1, b.c2));
  const Fp2 m01 = mul2(add2(a.c0, a.c1), add2(b.c0, b.c1));
  const Fp2 m02 = mul2(add2(a.c0, a.c2), add2(b.c0, b.c2));
  r.c0 = add2(t0, mul_xi(sub2(sub2(m12, t1), t2)));
  r.c1 = add2(sub2(sub2(m01, t0), t1), mul_xi(t2));
  r.c2 = add2(sub2(sub2(m02, t0), t2), t1);
}

// Cramer's rule: c0 = a0^2 - xi a1 a2, c1 = xi a2^2 - a0 a1,
// c2 = a1^2 - a0 a2, a^-1 = c / (a0 c0 + xi (a2 c1 + a1 c2)); 0 -> 0
static __device__ __noinline__ void inv6(Fp6& r, const Fp6& a) {
  const Fp2 c0 = sub2(sqr2(a.c0), mul_xi(mul2(a.c1, a.c2)));
  const Fp2 c1 = sub2(mul_xi(sqr2(a.c2)), mul2(a.c0, a.c1));
  const Fp2 c2 = sub2(sqr2(a.c1), mul2(a.c0, a.c2));
  const Fp2 t = add2(mul2(a.c0, c0), mul_xi(add2(mul2(a.c2, c1), mul2(a.c1, c2))));
  const Fp2 ti = inv2(t);
  r.c0 = mul2(c0, ti);
  r.c1 = mul2(c1, ti);
  r.c2 = mul2(c2, ti);
}

// -- Fp12 -------------------------------------------------------------------

__device__ __forceinline__ void one12(Fp12& r) {
  r.c0.c0 = one2();
  r.c0.c1 = zero2();
  r.c0.c2 = zero2();
  r.c1.c0 = zero2();
  r.c1.c1 = zero2();
  r.c1.c2 = zero2();
}

// the Frobenius p^6, the inverse on the cyclotomic subgroup
__device__ __forceinline__ void conj12(Fp12& r, const Fp12& a) {
  r.c0 = a.c0;
  neg6(r.c1, a.c1);
}

// Karatsuba over w^2 = v: c0 = a0 b0 + v a1 b1,
// c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1
static __device__ __noinline__ void mul12(Fp12& r, const Fp12& a, const Fp12& b) {
  Fp6 t0, t1, sa, sb, m;
  mul6(t0, a.c0, b.c0);
  mul6(t1, a.c1, b.c1);
  add6(sa, a.c0, a.c1);
  add6(sb, b.c0, b.c1);
  mul6(m, sa, sb);
  sub6(m, m, t0);
  sub6(r.c1, m, t1);
  mul_v(t1, t1);
  add6(r.c0, t0, t1);
}

// t = a0 a1, c0 = (a0 + a1)(a0 + v a1) - t - v t, c1 = 2 t
static __device__ __noinline__ void sqr12(Fp12& r, const Fp12& a) {
  Fp6 t, s, u, vt;
  mul6(t, a.c0, a.c1);
  add6(s, a.c0, a.c1);
  mul_v(u, a.c1);
  add6(u, a.c0, u);
  mul6(u, s, u);
  mul_v(vt, t);
  sub6(u, u, t);
  sub6(r.c0, u, vt);
  add6(r.c1, t, t);
}

// a^-1 = (a0 t, -a1 t), t = (a0^2 - v a1^2)^-1
static __device__ __noinline__ void inv12(Fp12& r, const Fp12& a) {
  Fp6 s0, s1, t;
  mul6(s0, a.c0, a.c0);
  mul6(s1, a.c1, a.c1);
  mul_v(s1, s1);
  sub6(s0, s0, s1);
  inv6(t, s0);
  mul6(r.c0, a.c0, t);
  mul6(s1, a.c1, t);
  neg6(r.c1, s1);
}

// (a + b s)^2 in Fp4 = Fp2[s] / (s^2 - xi): (a^2 + xi b^2, 2 a b)
__device__ __forceinline__ void fp4_sqr(Fp2& o0, Fp2& o1, const Fp2& a, const Fp2& b) {
  const Fp2 t0 = sqr2(a);
  const Fp2 t1 = sqr2(b);
  o0 = add2(t0, mul_xi(t1));
  o1 = sub2(sub2(sqr2(add2(a, b)), t0), t1);
}
__device__ __forceinline__ Fp2 tri_m(const Fp2& t, const Fp2& z) {  // 3t - 2z
  const Fp2 r = sub2(t, z);
  return add2(add2(r, r), t);
}
__device__ __forceinline__ Fp2 tri_p(const Fp2& t, const Fp2& z) {  // 3t + 2z
  const Fp2 r = add2(t, z);
  return add2(add2(r, r), t);
}

// Granger-Scott squaring, right only in the cyclotomic subgroup: with
// g = ((z0, z4, z3), (z2, z1, z5)), squarings in Fp4 of (z0, z1), (z2, z3)
// and (z4, z5), then 3t - 2z and 3t + 2z
static __device__ __noinline__ void cyc_sqr12(Fp12& r, const Fp12& g) {
  const Fp2 z0 = g.c0.c0, z4 = g.c0.c1, z3 = g.c0.c2;
  const Fp2 z2 = g.c1.c0, z1 = g.c1.c1, z5 = g.c1.c2;
  Fp2 a0, b0, a1, b1, a2, b2;
  fp4_sqr(a0, b0, z0, z1);
  fp4_sqr(a1, b1, z2, z3);
  fp4_sqr(a2, b2, z4, z5);
  r.c0.c0 = tri_m(a0, z0);
  r.c1.c1 = tri_p(b0, z1);
  r.c0.c1 = tri_m(a1, z4);
  r.c1.c2 = tri_p(b1, z5);
  r.c1.c0 = tri_p(mul_xi(b2), z2);
  r.c0.c2 = tri_m(a2, z3);
}

// a^p: coefficient c_k of w^k (c_(2j) = a.c0.cj, c_(2j+1) = a.c1.cj) goes
// to conj(c_k) gamma_k, gamma_k = xi^(k (p - 1) / 6)
static __device__ __noinline__ void frobenius12(Fp12& r, const Fp12& a, const Fp2 (&gamma)[6]) {
  r.c0.c0 = mul2(conj2(a.c0.c0), gamma[0]);
  r.c1.c0 = mul2(conj2(a.c1.c0), gamma[1]);
  r.c0.c1 = mul2(conj2(a.c0.c1), gamma[2]);
  r.c1.c1 = mul2(conj2(a.c1.c1), gamma[3]);
  r.c0.c2 = mul2(conj2(a.c0.c2), gamma[4]);
  r.c1.c2 = mul2(conj2(a.c1.c2), gamma[5]);
}

__device__ __forceinline__ bool eq_one12(const Fp12& a) {
  const Fp2 d = sub2(a.c0.c0, one2());
  return is_zero2(d) && is_zero2(a.c0.c1) && is_zero2(a.c0.c2) && is_zero2(a.c1.c0) &&
         is_zero2(a.c1.c1) && is_zero2(a.c1.c2);
}

// -- the [12, 12, M] layout of pairing.cu: coefficient 6 i + 2 j + k of an
// Fp12 value is a.ci.cj.ck, one Fp [12, M] block each ------------------------

__device__ __forceinline__ Fp2& slot(Fp12& a, int s) {
  Fp6& h = s < 3 ? a.c0 : a.c1;
  const int j = s % 3;
  return j == 0 ? h.c0 : (j == 1 ? h.c1 : h.c2);
}

__device__ __forceinline__ void load12(Fp12& a, const uint32_t* __restrict__ base, int M, int m) {
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    Fp2& c = slot(a, s);
    c.c0 = fp::load(base + (size_t)(2 * s) * fp::NL * M, M, m);
    c.c1 = fp::load(base + (size_t)(2 * s + 1) * fp::NL * M, M, m);
  }
}

__device__ __forceinline__ void store12(uint32_t* __restrict__ base, int M, int m, Fp12& a) {
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const Fp2& c = slot(a, s);
    fp::store(base + (size_t)(2 * s) * fp::NL * M, M, m, c.c0);
    fp::store(base + (size_t)(2 * s + 1) * fp::NL * M, M, m, c.c1);
  }
}

}  // namespace tower
