// The pairing check's kernels for Hopper (sm_90a): pairing_miller_loop and
// pairing_final_exp, the opt-in device pairing tier of verification.
//
// The JAX package has no Pallas kernel here: its pairing is XLA
// (lambdaworks_kzg_tpu/ops/pairing_ops.py), lax.scans over the bits of the
// BLS parameter. These two kernels replace
//   pairing_miller_loop <- g1_to_affine (:267) + g2_to_affine (:277) +
//                          miller_loop (:176): per pair, the affine points,
//                          the validity mask, the Miller loop over the bits
//                          of |x| below its top bit in homogeneous
//                          projective twist coordinates with sparse lines
//                          (_dbl_step :93, _add_step :126), invalid pairs
//                          set to one, and the conjugation for x < 0;
//   pairing_final_exp   <- lane_product (:202) + final_exp_cubed (:243) +
//                          tower_ops.fp12_eq_one (:228): the product of the
//                          pairs' values, FE(f)^3 by the x-chain, and its
//                          == 1.
// Their plain versions are ops/pairing_ops.py miller_loop_jac and
// final_exp_check, compositions of the port's plain tower
// (ops/fp2_ops.py, ops/tower_ops.py). The formulas are the same, and every
// field value is fully reduced (tower.cuh), so each output equals the
// plain version's limb for limb. The plain loops, like these, branch on the
// static bits where JAX selects; the lane product runs here as one chain
// where the plain version multiplies halves pairwise: the product is the
// same field value.
//
// Layout: limbs-first u32 arrays in Montgomery form (g1.cu): G1 Jacobian
// [3, 12, B]; G2 Jacobian [3, 2, 12, B] (coordinate, Fp2 component, limb,
// lane); Miller values [12, 12, B], twelve Fp coefficients in the order of
// tower.cuh's load12 / store12 (the plain tower's flatten12); the
// Frobenius constants gamma_k = xi^(k (p - 1) / 6) as [6, 2, 12], computed
// by the wrapper from the port's own host field; the bits of |x| and
// |x - 1| as 64-bit arguments.
//
// What bounds them: the dependent chain of Fp products in one thread. A
// Miller loop is 63 doubling steps and 5 addition steps, ~9,800 Montgomery
// products per pair, every one waiting on the one before it; the final
// exponentiation is an Fp inversion (~610 products), five 64-bit powers of
// Granger-Scott squarings (~1,450 products each) and ~20 Fp12 products,
// ~8,100 in all. At ~2,930 cycles per dependent fp::mul on an H100
// (scripts/probe_coop_field.py) that is tens of ms per check (18.9 and
// 16.6 ms at B = 2, PERF.md), while the same products as integer
// multiply-adds at the card's rate take under 1 us: the kernels are
// chain-bound, and the one or two threads of a check leave the card idle.
// The design is the simplest right one: one thread per pair for the Miller
// loop (a verification has two pairs), one thread for the final
// exponentiation. A redesign would move the tower onto the cooperative
// field of fp_coop.cuh (four threads per Fp product), spread the
// independent Fp2 products of each Fp6 and Fp12 step across threads, and
// multiply by the sparse lines with a sparse product.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tower.cuh"

namespace {

using fp::Fp;
using tower::Fp12;
using tower::Fp2;

constexpr int kThreads = 32;

__device__ __forceinline__ Fp2 load2(const uint32_t* __restrict__ base, int M, int m) {
  return {fp::load(base, M, m), fp::load(base + (size_t)fp::NL * M, M, m)};
}

__device__ __forceinline__ Fp2 smul3(const Fp2& a) { return tower::add2(tower::dbl2(a), a); }
__device__ __forceinline__ Fp2 smul8(const Fp2& a) {
  return tower::dbl2(tower::dbl2(tower::dbl2(a)));
}
__device__ __forceinline__ Fp2 smul9(const Fp2& a) { return tower::add2(smul8(a), a); }
__device__ __forceinline__ Fp2 smul27(const Fp2& a) {
  const Fp2 t9 = smul9(a);
  return tower::add2(tower::dbl2(t9), t9);
}
__device__ __forceinline__ Fp2 smul36(const Fp2& a) { return tower::dbl2(tower::dbl2(smul9(a))); }

// f * ((c0, c2, 0), (0, c3, 0)), the sparse line as a full Fp12 value
static __device__ __noinline__ void mul_line(Fp12& f, Fp2 c0, Fp2 c2, Fp2 c3) {
  Fp12 l;
  l.c0.c0 = c0;
  l.c0.c1 = c2;
  l.c0.c2 = tower::zero2();
  l.c1.c0 = tower::zero2();
  l.c1.c1 = c3;
  l.c1.c2 = tower::zero2();
  tower::mul12(f, f, l);
}

// T = (X, Y, Z) projective on E'(Fp2) -> 2T, and f times the tangent's line
// at P = (xp, yp): c0 = 3X^3 - 2Y^2Z, c2 = -3 X^2 Z xp, c3 = 2 Y Z^2 yp
static __device__ __noinline__ void dbl_step(Fp2& X, Fp2& Y, Fp2& Z, Fp12& f, Fp xp, Fp yp) {
  using namespace tower;
  const Fp2 X2 = sqr2(X);
  const Fp2 X3p = mul2(X2, X);
  const Fp2 Y2 = sqr2(Y);
  const Fp2 YZ = mul2(Y, Z);
  const Fp2 Y2Z = mul2(Y2, Z);
  const Fp2 YZ2 = mul2(YZ, Z);
  const Fp2 c0 = sub2(smul3(X3p), dbl2(Y2Z));
  const Fp2 c2 = neg2(smul3(mul2_fp(mul2(X2, Z), xp)));
  const Fp2 c3 = dbl2(mul2_fp(YZ2, yp));
  const Fp2 Xn = mul2(dbl2(YZ), sub2(smul9(mul2(X3p, X)), smul8(mul2(X, Y2Z))));
  const Fp2 Yn = sub2(sub2(smul36(mul2(mul2(X3p, Y2), Z)), smul27(sqr2(X3p))), smul8(sqr2(Y2Z)));
  Z = smul8(mul2(Y2Z, YZ2));
  X = Xn;
  Y = Yn;
  mul_line(f, c0, c2, c3);
}

// T projective + Q = (xq, yq) affine, and f times their line at P; with
// N = Y - yq Z, D = X - xq Z: c0 = N xq - yq D, c2 = -N xp, c3 = D yp
static __device__ __noinline__ void add_step(Fp2& X, Fp2& Y, Fp2& Z, Fp12& f, Fp2 xq, Fp2 yq,
                                             Fp xp, Fp yp) {
  using namespace tower;
  const Fp2 N = sub2(Y, mul2(yq, Z));
  const Fp2 D = sub2(X, mul2(xq, Z));
  const Fp2 N2 = sqr2(N);
  const Fp2 D2 = sqr2(D);
  const Fp2 D3 = mul2(D2, D);
  const Fp2 D2Z = mul2(D2, Z);
  const Fp2 xqD2Z = mul2(D2Z, xq);
  const Fp2 N2Z = mul2(N2, Z);
  const Fp2 D2X = mul2(D2, X);
  const Fp2 c0 = sub2(mul2(N, xq), mul2(yq, D));
  const Fp2 c2 = neg2(mul2_fp(N, xp));
  const Fp2 c3 = mul2_fp(D, yp);
  const Fp2 Xn = mul2(sub2(N2Z, add2(D2X, xqD2Z)), D);
  const Fp2 Yn = sub2(mul2(N, sub2(add2(dbl2(xqD2Z), D2X), N2Z)), mul2(mul2(yq, D3), Z));
  Z = mul2(D3, Z);
  X = Xn;
  Y = Yn;
  mul_line(f, c0, c2, c3);
}

__global__ void __launch_bounds__(kThreads)
    pairing_miller_loop_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                               uint32_t* __restrict__ out, int B, unsigned long long x_abs) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  const size_t blk = (size_t)fp::NL * B;  // one Fp [12, B] block
  Fp12 f;
  tower::one12(f);
  const Fp Z1 = fp::load(p + 2 * blk, B, m);
  const Fp2 Z2 = load2(q + 4 * blk, B, m);
  if (!fp::is_zero(Z1) && !tower::is_zero2(Z2)) {
    // the affine points: x = X / Z^2, y = Y / Z^3
    const Fp zi = fp::inv(Z1);
    const Fp zi2 = fp::sqr(zi);
    const Fp xp = fp::mul(fp::load(p, B, m), zi2);
    const Fp yp = fp::mul(fp::load(p + blk, B, m), fp::mul(zi2, zi));
    const Fp2 wi = tower::inv2(Z2);
    const Fp2 wi2 = tower::sqr2(wi);
    const Fp2 xq = tower::mul2(load2(q, B, m), wi2);
    const Fp2 yq = tower::mul2(load2(q + 2 * blk, B, m), tower::mul2(wi2, wi));
    Fp2 X = xq, Y = yq, Z = tower::one2();
    const int top = 63 - __clzll(x_abs);
#pragma unroll 1
    for (int i = top - 1; i >= 0; --i) {
      tower::sqr12(f, f);
      dbl_step(X, Y, Z, f, xp, yp);
      if ((x_abs >> i) & 1ull) add_step(X, Y, Z, f, xq, yq, xp, yp);
    }
    tower::conj12(f, f);  // x < 0
  }
  tower::store12(out, B, m, f);
}

// m^e for m in the cyclotomic subgroup, e = |x| or |x - 1| by its bits from
// the top: Granger-Scott squarings, a product at each set bit below the top
// (the plain version starts from one, whose squaring is one)
static __device__ __noinline__ void pow_abs(Fp12& r, const Fp12& m, unsigned long long e) {
  Fp12 base = m;
  r = m;
  const int top = 63 - __clzll(e);
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    tower::cyc_sqr12(r, r);
    if ((e >> i) & 1ull) tower::mul12(r, r, base);
  }
}

__global__ void pairing_final_exp_kernel(const uint32_t* __restrict__ f,
                                         const uint32_t* __restrict__ gamma_in,
                                         uint32_t* __restrict__ out, uint8_t* __restrict__ ok,
                                         int B, unsigned long long x_abs,
                                         unsigned long long xm1_abs) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  using namespace tower;
  Fp2 gamma[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) gamma[k] = load2(gamma_in + (size_t)k * 2 * fp::NL, 1, 0);
  // the product of the pairs' values
  Fp12 acc, t, m, bm, c, g;
  load12(acc, f, B, 0);
#pragma unroll 1
  for (int i = 1; i < B; ++i) {
    load12(t, f, B, i);
    mul12(acc, acc, t);
  }
  // the easy part: m = f^((p^6 - 1)(p^2 + 1)), cyclotomic
  inv12(t, acc);
  conj12(acc, acc);
  mul12(t, acc, t);
  frobenius12(m, t, gamma);
  frobenius12(m, m, gamma);
  mul12(m, m, t);
  // the hard part, cubed: m^((x - 1)^2 (x + p)(x^2 + p^2 - 1) + 3)
  pow_abs(bm, m, xm1_abs);
  conj12(bm, bm);
  pow_abs(bm, bm, xm1_abs);
  conj12(bm, bm);  // m^((x - 1)^2)
  pow_abs(c, bm, x_abs);
  conj12(c, c);
  frobenius12(t, bm, gamma);
  mul12(c, c, t);  // bm^(x + p)
  pow_abs(g, c, x_abs);
  conj12(g, g);
  pow_abs(g, g, x_abs);
  conj12(g, g);  // c^(x^2)
  frobenius12(t, c, gamma);
  frobenius12(t, t, gamma);
  mul12(g, g, t);
  conj12(c, c);
  mul12(g, g, c);  // c^(x^2 + p^2 - 1)
  cyc_sqr12(t, m);
  mul12(t, t, m);
  mul12(g, g, t);  // times m^3
  store12(out, 1, 0, g);
  *ok = eq_one12(g) ? 1 : 0;
}

}  // namespace

extern "C" int lwkzg_pairing_miller_loop(const void* p, const void* q, void* out, int B,
                                         unsigned long long x_abs, void* stream) {
  pairing_miller_loop_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                               (cudaStream_t)stream>>>((const uint32_t*)p, (const uint32_t*)q,
                                                       (uint32_t*)out, B, x_abs);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_pairing_final_exp(const void* f, const void* gamma, void* out, void* ok,
                                       int B, unsigned long long x_abs,
                                       unsigned long long xm1_abs, void* stream) {
  pairing_final_exp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (const uint32_t*)gamma, (uint32_t*)out, (uint8_t*)ok, B, x_abs,
      xm1_abs);
  return (int)cudaGetLastError();
}
