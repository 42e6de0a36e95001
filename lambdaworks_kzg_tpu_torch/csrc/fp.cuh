// Montgomery arithmetic in the BLS12-381 base field Fp for the G1 kernels
// (g1.cu, msm.cu): 12 x 32-bit limbs, little-endian, R = 2^384. A value in
// Montgomery form is the same integer as in the radix-2^16 limbs of the
// Python side (ops/limbs.py); only the radix differs. Every function
// returns a fully reduced value in [0, p), so results equal the plain
// PyTorch field (ops/field_ops.py) bit for bit.
//
// Replaces the in-kernel field of the TPU kernels,
// lambdaworks_kzg_tpu/ops/pallas_g1_v2.py::_KernelFp (radix-2^16
// schoolbook + REDC over [24, S, 128] vregs). Here one thread owns one
// field element and the product is CIOS over 32-bit words with PTX carry
// chains (mad.lo.cc / madc.hi.cc / addc.cc): per word of b, one chain adds
// the low halves of a * b_i, a second the high halves one word up, and two
// more do the same for m * p. That is 4 x 12 multiply-adds and one product
// for m per word, 588 per multiplication, with no 64-bit accumulator
// arithmetic around them (the first design's plain C++ uint64_t CIOS spent
// extra adds and shifts on every carry). The carry flag lives between
// consecutive asm volatile statements, which the compiler keeps in order;
// no other instruction that writes it sits between them. The square
// (sqr) shares its cross products and reduces the 24-word square with the
// same rounds of m * p: 456 multiply-adds.
#pragma once
#include <stdint.h>

namespace fp {

constexpr int NL = 12;

struct Fp {
  uint32_t v[NL];
};

// p, R mod p (Montgomery one) and -p^-1 mod 2^32; static, like mul below,
// so each source that includes this header keeps its own copy and both
// link into one library
static __constant__ Fp kP = {{0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                              0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                              0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau}};
static __constant__ Fp kOne = {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                                0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                                0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u}};
constexpr uint32_t kPInv = 0xfffcfffdu;

// -- single PTX instructions with the carry flag (CC) --------------------
namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo/hi(a * b) + c, carry out (and in, for madc)
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx

// Limb k of lane m of an [NL, M] limbs-first array starts at base[k*M + m].
__device__ __forceinline__ Fp load(const uint32_t* __restrict__ base, int M,
                                   int m) {
  Fp a;
#pragma unroll
  for (int k = 0; k < NL; ++k) a.v[k] = base[(size_t)k * M + m];
  return a;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ base, int M,
                                      int m, const Fp& a) {
#pragma unroll
  for (int k = 0; k < NL; ++k) base[(size_t)k * M + m] = a.v[k];
}

__device__ __forceinline__ Fp zero() {
  Fp a;
#pragma unroll
  for (int k = 0; k < NL; ++k) a.v[k] = 0u;
  return a;
}

__device__ __forceinline__ Fp one() { return kOne; }

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < NL; ++k) acc |= a.v[k];
  return acc == 0u;
}

// a in [0, 2p) -> a mod p
__device__ __forceinline__ Fp reduce_once(const Fp& a) {
  Fp d;
  d.v[0] = ptx::sub_cc(a.v[0], kP.v[0]);
#pragma unroll
  for (int k = 1; k < NL; ++k) d.v[k] = ptx::subc_cc(a.v[k], kP.v[k]);
  const uint32_t borrow = ptx::subc(0u, 0u);  // all ones when a < p
  Fp r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.v[k] = (a.v[k] & borrow) | (d.v[k] & ~borrow);
  return r;
}

__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  Fp s;  // a + b < 2p < 2^384: no carry out of the top word
  s.v[0] = ptx::add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) s.v[k] = ptx::addc_cc(a.v[k], b.v[k]);
  s.v[NL - 1] = ptx::addc(a.v[NL - 1], b.v[NL - 1]);
  return reduce_once(s);
}

__device__ __forceinline__ Fp dbl(const Fp& a) { return add(a, a); }

__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  Fp d;
  d.v[0] = ptx::sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < NL; ++k) d.v[k] = ptx::subc_cc(a.v[k], b.v[k]);
  const uint32_t mask = ptx::subc(0u, 0u);  // a < b: add p back (mod 2^384)
  Fp r;
  r.v[0] = ptx::add_cc(d.v[0], kP.v[0] & mask);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) r.v[k] = ptx::addc_cc(d.v[k], kP.v[k] & mask);
  r.v[NL - 1] = ptx::addc(d.v[NL - 1], kP.v[NL - 1] & mask);
  return r;
}

// One REDC round on 13 words: t += m * p with m = t_0 * (-p^-1), so t_0
// becomes 0, then t /= 2^32. With t < 2^384 before it, t + m p < 2^414
// fits 13 words and t < 2^384 again after it.
__device__ __forceinline__ void redc_round(uint32_t (&t)[NL + 1]) {
  const uint32_t m = t[0] * kPInv;
  t[0] = ptx::mad_lo_cc(m, kP.v[0], t[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) t[j] = ptx::madc_lo_cc(m, kP.v[j], t[j]);
  t[NL] = ptx::addc(t[NL], 0u);
  t[1] = ptx::mad_hi_cc(m, kP.v[0], t[1]);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j)
    t[j + 1] = ptx::madc_hi_cc(m, kP.v[j], t[j + 1]);
  t[NL] = ptx::madc_hi(m, kP.v[NL - 1], t[NL]);
#pragma unroll
  for (int k = 0; k < NL; ++k) t[k] = t[k + 1];
  t[NL] = 0u;
}

// Montgomery product a * b * 2^-384 mod p (CIOS). t holds 13 words: with
// a, b < p < 2^381, t + a b_i + m p < 2^414 before each shift, so no sum
// carries out of t[12], and t < 2p < 2^383 (t[12] = 0) after it.
//
// Not inlined: a point op makes 8 to 16 products of ~1,000 instructions
// each, and inlined copies made each kernel's straight-line code longer
// than the instruction cache, so a thread waited on instruction fetch for
// most of its time (a chain of madds on an H100: 41.0 us inlined, 16.6 us
// with this one shared copy). The call passes 24 words in registers.
static __device__ __noinline__ Fp mul(Fp a, Fp b) {
  uint32_t t[NL + 1];
#pragma unroll
  for (int k = 0; k < NL + 1; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t bi = b.v[i];
    // t += a * b_i: low halves at word j, then high halves at word j + 1
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
  Fp r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.v[k] = t[k];
  return reduce_once(r);
}

// Montgomery square a * a * 2^-384 mod p, equal to mul(a, a) bit for bit.
// The 24-word square computes each cross product a_i a_j (i < j) once:
// row i adds a_i * (a_{i+1} .. a_11) at word 2i + 1, the 66 cross products
// are doubled by one shift, and the 12 squares a_i^2 are added at word 2i,
// 78 wide products against mul's 144. Rows 0 .. i sum below 2^(32 (i + 13)),
// so word i + 12 (zero before row i) takes the row's carries and nothing
// carries out of it. Then a^2 = t_hi R + t_lo gives a^2 / R = t_hi +
// REDC(t_lo) mod p: twelve redc_rounds of u = t_lo leave u = (t_lo + M p)
// / R <= p, and t_hi + u < p^2 / R + p + 1 < 2p needs one reduce_once. In
// all 456 multiply-adds against mul's 588; the counterpart of the TPU
// kernels' _sqr_acc (ops/pallas_g1.py:142). Not inlined, as mul.
static __device__ __noinline__ Fp sqr(Fp a) {
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
  // the last row is the one product a_10 a_11, at words 21 and 22
  t[2 * NL - 3] = ptx::mad_lo_cc(a.v[NL - 2], a.v[NL - 1], t[2 * NL - 3]);
  t[2 * NL - 2] = ptx::madc_hi(a.v[NL - 2], a.v[NL - 1], t[2 * NL - 2]);
  // double the cross products (they sum below 2^(32 * 23))
#pragma unroll
  for (int k = 2 * NL - 1; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  // the squares a_i^2 at words 2i, 2i + 1; a^2 < 2^768 carries out of nothing
  t[0] = ptx::mad_lo_cc(a.v[0], a.v[0], t[0]);
  t[1] = ptx::madc_hi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) {
    t[2 * i] = ptx::madc_lo_cc(a.v[i], a.v[i], t[2 * i]);
    t[2 * i + 1] = ptx::madc_hi_cc(a.v[i], a.v[i], t[2 * i + 1]);
  }
  t[2 * NL - 2] = ptx::madc_lo_cc(a.v[NL - 1], a.v[NL - 1], t[2 * NL - 2]);
  t[2 * NL - 1] = ptx::madc_hi(a.v[NL - 1], a.v[NL - 1], t[2 * NL - 1]);
  // REDC of the low half, then add the high half
  uint32_t u[NL + 1];
#pragma unroll
  for (int k = 0; k < NL; ++k) u[k] = t[k];
  u[NL] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) redc_round(u);
  Fp r;
  r.v[0] = ptx::add_cc(t[NL], u[0]);
#pragma unroll
  for (int k = 1; k < NL - 1; ++k) r.v[k] = ptx::addc_cc(t[NL + k], u[k]);
  r.v[NL - 1] = ptx::addc(t[2 * NL - 1], u[NL - 1]);
  return reduce_once(r);
}

// a^-1 = a^(p - 2) (Fermat), 0 -> 0: square-and-multiply from the top bit
// of p - 2 (bit 380), 380 squarings and 228 products, with the bits read
// from kP (p - 2 differs from p only in its lowest word, 0xffffaaa9).
static __device__ __noinline__ Fp inv(Fp a) {
  Fp r = a;
#pragma unroll 1
  for (int w = NL - 1; w >= 0; --w) {
    const uint32_t e = w ? kP.v[w] : kP.v[0] - 2u;
#pragma unroll 1
    for (int bit = w == NL - 1 ? 27 : 31; bit >= 0; --bit) {
      r = sqr(r);
      if ((e >> bit) & 1u) r = mul(r, a);
    }
  }
  return r;
}

}  // namespace fp
