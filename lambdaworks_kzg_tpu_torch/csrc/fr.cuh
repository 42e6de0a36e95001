// Montgomery arithmetic in the BLS12-381 scalar field Fr for the Fr
// polynomial kernels (fr_poly.cu): 8 x 32-bit limbs, little-endian,
// R = 2^256. A value in Montgomery form is the same integer as in the
// radix-2^16 limbs of the Python side (ops/field_ops.py FR, 16 limbs with
// R = 2^256); only the radix differs (ops/limbs.py to_u32_layout). Every
// function returns a fully reduced value in [0, r), so results equal the
// plain PyTorch field bit for bit.
//
// Replaces the XLA field of the JAX package's Fr programs
// (lambdaworks_kzg_tpu/ops/field_ops.py FR under ops/fr_poly.py's jitted
// kernels). The product is fp.cuh's CIOS on the PTX carry chains
// (fp::ptx), at 8 words: per word of b one chain adds the low halves of
// a * b_i, a second the high halves one word up, and two more do the same
// for m * r, 4 x 8 x 8 = 256 multiply-adds and one product for m per
// word, 264 in all. r < 2^255, so with a, b < r the running sum stays
// below 2r before each shift and 2^33 r < 2^288 fits the 9 words. The
// square shares its 28 cross products (36 wide products against mul's
// 64) and reduces the 16-word square with the same rounds: 208
// multiply-adds.
#pragma once
#include <stdint.h>

#include "fp.cuh"  // fp::ptx, the single instructions with the carry flag

namespace fr {

constexpr int NL = 8;

struct Fr {
  uint32_t v[NL];
};

namespace ptx = fp::ptx;

// r, R mod r (Montgomery one), R^2 mod r, and r - 2, the exponent of the
// Fermat inversion; -r^-1 mod 2^32 is 0xffffffff (r = 1 mod 2^32). Static
// as in fp.cuh: each source that includes this header keeps its own copy.
static __constant__ Fr kR = {{0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                              0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u}};
static __constant__ Fr kOne = {{0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                                0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u}};
static __constant__ Fr kR2 = {{0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                               0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u}};
static __constant__ Fr kRMinus2 = {{0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
                                    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u}};
constexpr uint32_t kRInv = 0xffffffffu;

// Limb k of element i of an [NL, n] limbs-first array starts at
// base[k * n + i].
__device__ __forceinline__ Fr load(const uint32_t* __restrict__ base, int n,
                                   int i) {
  Fr a;
#pragma unroll
  for (int k = 0; k < NL; ++k) a.v[k] = base[(size_t)k * n + i];
  return a;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ base, int n,
                                      int i, const Fr& a) {
#pragma unroll
  for (int k = 0; k < NL; ++k) base[(size_t)k * n + i] = a.v[k];
}

__device__ __forceinline__ Fr zero() {
  Fr a;
#pragma unroll
  for (int k = 0; k < NL; ++k) a.v[k] = 0u;
  return a;
}

__device__ __forceinline__ Fr one() { return kOne; }

// a in [0, 2r) -> a mod r
__device__ __forceinline__ Fr reduce_once(const Fr& a) {
  Fr d;
  d.v[0] = ptx::sub_cc(a.v[0], kR.v[0]);
#pragma unroll
  for (int k = 1; k < NL; ++k) d.v[k] = ptx::subc_cc(a.v[k], kR.v[k]);
  const uint32_t borrow = ptx::subc(0u, 0u);  // all ones when a < r
  Fr out;
#pragma unroll
  for (int k = 0; k < NL; ++k) out.v[k] = (a.v[k] & borrow) | (d.v[k] & ~borrow);
  return out;
}

__device__ __forceinline__ Fr add(const Fr& a, const Fr& b) {
  Fr s;  // a + b < 2r < 2^256: no carry out of the top word
  s.v[0] = ptx::add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) s.v[k] = ptx::addc_cc(a.v[k], b.v[k]);
  s.v[NL - 1] = ptx::addc(a.v[NL - 1], b.v[NL - 1]);
  return reduce_once(s);
}

__device__ __forceinline__ Fr sub(const Fr& a, const Fr& b) {
  Fr d;
  d.v[0] = ptx::sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < NL; ++k) d.v[k] = ptx::subc_cc(a.v[k], b.v[k]);
  const uint32_t mask = ptx::subc(0u, 0u);  // a < b: add r back (mod 2^256)
  Fr out;
  out.v[0] = ptx::add_cc(d.v[0], kR.v[0] & mask);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) out.v[k] = ptx::addc_cc(d.v[k], kR.v[k] & mask);
  out.v[NL - 1] = ptx::addc(d.v[NL - 1], kR.v[NL - 1] & mask);
  return out;
}

// -a mod r: 0 stays 0
__device__ __forceinline__ Fr neg(const Fr& a) { return sub(zero(), a); }

// One REDC round on 9 words: t += m * r with m = t_0 * (-r^-1), so t_0
// becomes 0, then t /= 2^32. With t < 2^256 before it, t + m r < 2^288
// fits 9 words and t < 2^256 again after it.
__device__ __forceinline__ void redc_round(uint32_t (&t)[NL + 1]) {
  const uint32_t m = t[0] * kRInv;
  t[0] = ptx::mad_lo_cc(m, kR.v[0], t[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) t[j] = ptx::madc_lo_cc(m, kR.v[j], t[j]);
  t[NL] = ptx::addc(t[NL], 0u);
  t[1] = ptx::mad_hi_cc(m, kR.v[0], t[1]);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j)
    t[j + 1] = ptx::madc_hi_cc(m, kR.v[j], t[j + 1]);
  t[NL] = ptx::madc_hi(m, kR.v[NL - 1], t[NL]);
#pragma unroll
  for (int k = 0; k < NL; ++k) t[k] = t[k + 1];
  t[NL] = 0u;
}

// Montgomery product a * b * 2^-256 mod r (CIOS), a, b < r: t + a b_i +
// m r < 2^33 r < 2^288 before each shift, and t < 2r < 2^256 (t[8] = 0)
// after it. Not inlined, as fp::mul: one shared copy keeps the kernels'
// straight-line code inside the instruction cache.
static __device__ __noinline__ Fr mul(Fr a, Fr b) {
  uint32_t t[NL + 1];
#pragma unroll
  for (int k = 0; k < NL + 1; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t bi = b.v[i];
    t[0] = ptx::mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < NL; ++j) t[j] = ptx::madc_lo_cc(a.v[j], bi, t[j]);
    t[NL] = ptx::addc(t[NL], 0u);
    t[1] = ptx::mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < NL - 1; ++j)
      t[j + 1] = ptx::madc_hi_cc(a.v[j], bi, t[j + 1]);
    t[NL] = ptx::madc_hi(a.v[NL - 1], bi, t[NL]);
    redc_round(t);
  }
  Fr out;
#pragma unroll
  for (int k = 0; k < NL; ++k) out.v[k] = t[k];
  return reduce_once(out);
}

// Montgomery square, equal to mul(a, a) bit for bit: fp::sqr at 8 words.
// Row i adds a_i * (a_{i+1} .. a_7) at word 2i + 1 (rows 0 .. i sum below
// 2^(32 (i + 9)), so word i + 8 takes the row's carries), the cross
// products are doubled by one shift, the squares a_i^2 added at word 2i;
// then a^2 / R = t_hi + REDC(t_lo), where eight redc_rounds leave
// u = (t_lo + M r) / R <= r and t_hi + u < r^2 / R + r + 1 < 2r needs one
// reduce_once. Not inlined, as mul.
static __device__ __noinline__ Fr sqr(Fr a) {
  uint32_t t[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL - 2; ++i) {
    const uint32_t ai = a.v[i];
    t[2 * i + 1] = ptx::mad_lo_cc(ai, a.v[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < NL; ++j) t[i + j] = ptx::madc_lo_cc(ai, a.v[j], t[i + j]);
    t[i + NL] = ptx::addc(t[i + NL], 0u);
    t[2 * i + 2] = ptx::mad_hi_cc(ai, a.v[i + 1], t[2 * i + 2]);
#pragma unroll
    for (int j = i + 2; j < NL - 1; ++j)
      t[i + j + 1] = ptx::madc_hi_cc(ai, a.v[j], t[i + j + 1]);
    t[i + NL] = ptx::madc_hi(ai, a.v[NL - 1], t[i + NL]);
  }
  // the last row is the one product a_6 a_7, at words 13 and 14
  t[2 * NL - 3] = ptx::mad_lo_cc(a.v[NL - 2], a.v[NL - 1], t[2 * NL - 3]);
  t[2 * NL - 2] = ptx::madc_hi(a.v[NL - 2], a.v[NL - 1], t[2 * NL - 2]);
#pragma unroll
  for (int k = 2 * NL - 1; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] = ptx::mad_lo_cc(a.v[0], a.v[0], t[0]);
  t[1] = ptx::madc_hi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) {
    t[2 * i] = ptx::madc_lo_cc(a.v[i], a.v[i], t[2 * i]);
    t[2 * i + 1] = ptx::madc_hi_cc(a.v[i], a.v[i], t[2 * i + 1]);
  }
  t[2 * NL - 2] = ptx::madc_lo_cc(a.v[NL - 1], a.v[NL - 1], t[2 * NL - 2]);
  t[2 * NL - 1] = ptx::madc_hi(a.v[NL - 1], a.v[NL - 1], t[2 * NL - 1]);
  uint32_t u[NL + 1];
#pragma unroll
  for (int k = 0; k < NL; ++k) u[k] = t[k];
  u[NL] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) redc_round(u);
  Fr out;
  out.v[0] = ptx::add_cc(t[NL], u[0]);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) out.v[k] = ptx::addc_cc(t[NL + k], u[k]);
  out.v[NL - 1] = ptx::addc(t[2 * NL - 1], u[NL - 1]);
  return reduce_once(out);
}

// plain a < r -> a R mod r, and back: a R^-1 mod r (a product by the
// integer 1)
__device__ __forceinline__ Fr to_mont(const Fr& a) { return mul(a, kR2); }

__device__ __forceinline__ Fr from_mont(const Fr& a) {
  Fr unit = zero();
  unit.v[0] = 1u;
  return mul(a, unit);
}

// a^-1 = a^(r - 2) (Fermat), 0 -> 0, by a fixed 4-bit window from the top
// nibble: the powers a^0 .. a^15 (14 products), then per nibble of r - 2
// below the top 4 squarings and, for a nonzero nibble (59 of the 63), one
// product; 252 squarings and 73 products in all, where FR.inv's 1-bit
// chain takes 254 squarings and 164 products. The table sits in the
// calling thread's local memory.
static __device__ __noinline__ Fr inv(Fr a) {
  Fr pw[16];
  pw[0] = one();
  pw[1] = a;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) pw[k] = mul(pw[k - 1], a);
  Fr acc = pw[kRMinus2.v[NL - 1] >> 28];
#pragma unroll 1
  for (int nib = 8 * NL - 2; nib >= 0; --nib) {
    acc = sqr(sqr(sqr(sqr(acc))));
    const uint32_t d = (kRMinus2.v[nib >> 3] >> (4 * (nib & 7))) & 15u;
    if (d) acc = mul(acc, pw[d]);
  }
  return acc;
}

}  // namespace fr
