// Cooperative Montgomery arithmetic in Fp for the batched G1 kernels
// (g1_batch.cu): a group of kT = 4 neighbouring threads of a warp shares
// one field element, each thread holding kS = 3 of its 12 x 32-bit words
// (rank r holds words 3r .. 3r + 2, little-endian, Montgomery form with
// R = 2^384 as in fp.cuh). Every function returns the fully reduced
// value in [0, p), the same words as fp::mul, fp::sqr, fp::add and fp::sub
// give, so a group law written on these equals the one on fp.cuh (and the
// plain PyTorch versions) limb for limb.
//
// Why: fp::mul is one thread's PTX carry chain of 588 dependent
// multiply-adds, ~2,900 cycles of latency on an H100 (scripts/
// probe_coop_field.py), and the batched G1 kernels have too few lanes (an
// FFT stage's 2048, a batch verification's 12) to hide it behind other
// warps. Here each thread runs about half as long a chain: ~1,570 cycles
// a product, ~180 an add (fp::add: ~125).
//
// The multiply is CIOS in the radix 2^96 (one digit = one thread's 3
// words), 4 rounds instead of 12. Round j:
//   1. every thread adds its words of a times digit j of b (a 3 x 3
//      product, b's digits gathered once from their owners by shuffles)
//      into its 7-word window W at its own place;
//   2. m = W_0 * (-p^-1) mod 2^96 from rank 0's low digit (shuffled to
//      the group, computed by every thread), and every thread adds
//      m times its words of p, which zeroes the group's low digit;
//   3. the accumulator shifts down one digit: rank r takes its window's
//      upper digit, plus rank r + 1's lower digit, plus rank r - 1's top
//      word (2 shuffles deep), and keeps a carry bit c at its top.
// A word-level model of these bounds: W < 2^193 with its top word <= 1,
// c <= 1, and rank 3's carry is 0 since the value stays below 2p.
// After the rounds each rank adds the carry of the rank below, and the
// carries that ripple across ranks are resolved in one step from two warp
// ballots: with generate bits G and propagate bits P (all words at their
// maximum), the carries into the ranks are ((G|P) + G) ^ (G|P) ^ G, and
// the bit above the group's top rank is the carry out of the element.
// add, sub and the final subtraction of p resolve their carries and
// borrows the same way, so each needs no serial pass over the ranks.
//
// A thread's work per product is 4 rounds of two 3 x 3 products (9
// independent 32 x 32 -> 64-bit products each, summed per column in 64
// bits, which the compiler may interleave with the shuffles; as PTX
// carry chains like fp::mul's they took ~1,830 cycles a product, this
// way ~1,570), 6 products for m and ~22 chained adds, plus 14 shuffles
// and 4 ballots, against 588 chained multiply-adds in one thread for
// fp::mul. sqr is mul(a, a): its cross products a_i a_j and a_j a_i fall
// to different ranks in different rounds, so sharing them would cost
// another exchange. mul2 runs two independent products on a pair of
// groups at once.
//
// Warp convention: every sync intrinsic here names the whole warp, so all
// 32 threads of a warp must run every field op together, and a kernel
// built on these keeps its control flow the same across the warp (a
// branch on one group's data becomes a select, or a branch on a warp-wide
// any) and calls each sync intrinsic outside any && or ?: that could skip
// it on some threads. The groups' answers still stay apart: a shuffle of
// width kT stays inside its group, and a ballot is masked to the group's
// bits. (With a mask per group, which differs across the warp, a shuffle
// took ~250 cycles and a carry resolution ~1,200 on an H100; with the
// warp's mask, ~80 and ~95.)
#pragma once
#include <stdint.h>

#include "fp.cuh"

namespace fpc {

using fp::NL;
namespace ptx = fp::ptx;

constexpr int kT = 4;        // threads per field element
constexpr int kS = NL / kT;  // words per thread
static_assert(kT * kS == NL && 32 % kT == 0 && kS >= 2, "a group's words must tile Fp");

struct Fq {
  uint32_t v[kS];  // words kS * rank .. kS * rank + kS - 1
};

// -p^-1 mod 2^384; its low kS words are -p^-1 mod 2^(32 kS)
static __constant__ uint32_t kPInv[NL] = {
    0xfffcfffdu, 0x89f3fffcu, 0xd9d113e8u, 0x286adb92u, 0xc8e30b48u, 0x16ef2ef0u,
    0x8eb2db4cu, 0x19ecca0eu, 0xe268cf58u, 0x68b316feu, 0xfeaafc94u, 0xceb06106u};

constexpr uint32_t kWarp = 0xffffffffu;
// the top rank of every group of the warp: carries must not leave a group
constexpr uint32_t kTopRanks = 0xffffffffu / ((1u << kT) - 1u) << (kT - 1);

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }
__device__ __forceinline__ int rank() { return threadIdx.x & (kT - 1); }
// the bits of this thread's group in a warp ballot
__device__ __forceinline__ uint32_t group_bits() {
  return ((1u << kT) - 1u) << (lane() & ~(kT - 1));
}

// whether pred holds in any thread of the warp (a warp-uniform branch)
__device__ __forceinline__ bool warp_any(bool pred) { return __any_sync(kWarp, pred); }

// this rank's words of c, a __constant__ value: every index is known at
// compile time, so the words come as constant operands and a select by
// rank (an index by rank would split each warp's load four ways)
__device__ __forceinline__ Fq words_of(const fp::Fp& c) {
  const int r = rank();
  Fq w;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    uint32_t v = c.v[k];
#pragma unroll
    for (int j = 1; j < kT; ++j)
      if (r == j) v = c.v[j * kS + k];
    w.v[k] = v;
  }
  return w;
}

__device__ __forceinline__ Fq p_words() { return words_of(fp::kP); }

// -- moving words inside the group ---------------------------------------

__device__ __forceinline__ uint32_t from_rank(uint32_t v, int src) {
  return __shfl_sync(kWarp, v, src, kT);
}
// rank r gets rank r + 1's v; the top rank gets 0
__device__ __forceinline__ uint32_t from_above(uint32_t v) {
  const uint32_t w = __shfl_down_sync(kWarp, v, 1, kT);
  return rank() == kT - 1 ? 0u : w;
}
// rank r gets rank r - 1's v; rank 0 gets 0
__device__ __forceinline__ uint32_t from_below(uint32_t v) {
  const uint32_t w = __shfl_up_sync(kWarp, v, 1, kT);
  return rank() == 0 ? 0u : w;
}

// The carry into this rank, given per rank whether its words carried out
// (gen) and whether a carry into them would pass through (prop, never
// together with gen); `out` is the carry out of the top rank. The top
// ranks' bits are cleared before the add, so no carry crosses a group.
__device__ __forceinline__ uint32_t carry_in(bool gen, bool prop, uint32_t& out) {
  const uint32_t g_all = __ballot_sync(kWarp, gen);
  const uint32_t p_all = __ballot_sync(kWarp, prop);
  const uint32_t g = g_all & ~kTopRanks;
  const uint32_t a = (g_all | p_all) & ~kTopRanks;
  const uint32_t c = (a + g) ^ a ^ g;  // bit i: the carry into bit i
  const int top = (lane() & ~(kT - 1)) + kT - 1;
  out = ((g_all >> top) | ((p_all >> top) & (c >> top))) & 1u;
  return (c >> lane()) & 1u;
}

// -- local words ---------------------------------------------------------

__device__ __forceinline__ bool words_zero(const Fq& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < kS; ++k) acc |= a.v[k];
  return acc == 0u;
}

__device__ __forceinline__ bool words_max(const Fq& a) {
  uint32_t acc = ~0u;
#pragma unroll
  for (int k = 0; k < kS; ++k) acc &= a.v[k];
  return acc == ~0u;
}

// a + bit over this rank's words, the carry out dropped (resolved before)
__device__ __forceinline__ Fq add_bit(const Fq& a, uint32_t bit) {
  Fq r;
  r.v[0] = ptx::add_cc(a.v[0], bit);
#pragma unroll
  for (int k = 1; k < kS - 1; ++k) r.v[k] = ptx::addc_cc(a.v[k], 0u);
  r.v[kS - 1] = ptx::addc(a.v[kS - 1], 0u);
  return r;
}

__device__ __forceinline__ Fq sub_bit(const Fq& a, uint32_t bit) {
  Fq r;
  r.v[0] = ptx::sub_cc(a.v[0], bit);
#pragma unroll
  for (int k = 1; k < kS - 1; ++k) r.v[k] = ptx::subc_cc(a.v[k], 0u);
  r.v[kS - 1] = ptx::subc(a.v[kS - 1], 0u);
  return r;
}

// -- the field ------------------------------------------------------------

__device__ __forceinline__ Fq load(const uint32_t* __restrict__ base, int M, int m) {
  Fq a;
  const int o = rank() * kS;
#pragma unroll
  for (int k = 0; k < kS; ++k) a.v[k] = base[(size_t)(o + k) * M + m];
  return a;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ base, int M, int m, const Fq& a) {
  const int o = rank() * kS;
#pragma unroll
  for (int k = 0; k < kS; ++k) base[(size_t)(o + k) * M + m] = a.v[k];
}

__device__ __forceinline__ Fq zero() {
  Fq a;
#pragma unroll
  for (int k = 0; k < kS; ++k) a.v[k] = 0u;
  return a;
}

__device__ __forceinline__ bool is_zero(const Fq& a) {
  return (__ballot_sync(kWarp, !words_zero(a)) & group_bits()) == 0u;
}

__device__ __forceinline__ bool eq(const Fq& a, const Fq& b) {
  uint32_t d = 0u;
#pragma unroll
  for (int k = 0; k < kS; ++k) d |= a.v[k] ^ b.v[k];
  return (__ballot_sync(kWarp, d != 0u) & group_bits()) == 0u;
}

// a > b for values below 2^384: each rank compares its words from the
// top down, a ballot masked to the group finds the highest rank whose
// words differ, and a shuffle hands on that rank's verdict; a == b gives
// false
__device__ __forceinline__ bool gt(const Fq& a, const Fq& b) {
  bool g = false, differs = false;
#pragma unroll
  for (int k = kS - 1; k >= 0; --k) {
    const bool d = !differs && a.v[k] != b.v[k];
    g = d ? a.v[k] > b.v[k] : g;
    differs = differs || d;
  }
  const uint32_t ranks = (__ballot_sync(kWarp, differs) & group_bits()) >> (lane() & ~(kT - 1));
  const int top = ranks ? 31 - __clz((int)ranks) : 0;
  const bool verdict = __shfl_sync(kWarp, (int)g, top, kT) != 0;
  return ranks != 0u && verdict;
}

// s in [0, 2p) -> s mod p: subtract p with the borrows resolved, keep s
// where that borrows out of the top rank
__device__ __forceinline__ Fq reduce_once(const Fq& s) {
  const Fq p = p_words();
  Fq d;
  d.v[0] = ptx::sub_cc(s.v[0], p.v[0]);
#pragma unroll
  for (int k = 1; k < kS; ++k) d.v[k] = ptx::subc_cc(s.v[k], p.v[k]);
  const uint32_t borrow = ptx::subc(0u, 0u) & 1u;
  uint32_t below;  // s < p
  const uint32_t bin = carry_in(borrow != 0u, words_zero(d), below);
  d = sub_bit(d, bin);
  Fq r;
#pragma unroll
  for (int k = 0; k < kS; ++k) r.v[k] = below ? s.v[k] : d.v[k];
  return r;
}

__device__ __forceinline__ Fq add(const Fq& a, const Fq& b) {
  Fq s;  // a + b < 2p < 2^384: nothing carries out of the top rank
  s.v[0] = ptx::add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < kS; ++k) s.v[k] = ptx::addc_cc(a.v[k], b.v[k]);
  const uint32_t carry = ptx::addc(0u, 0u);
  uint32_t top;
  s = add_bit(s, carry_in(carry != 0u, words_max(s), top));
  return reduce_once(s);
}

__device__ __forceinline__ Fq dbl(const Fq& a) { return add(a, a); }

__device__ __forceinline__ Fq sub(const Fq& a, const Fq& b) {
  Fq d;
  d.v[0] = ptx::sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < kS; ++k) d.v[k] = ptx::subc_cc(a.v[k], b.v[k]);
  const uint32_t borrow = ptx::subc(0u, 0u) & 1u;
  uint32_t below;  // a < b: add p back (mod 2^384)
  d = sub_bit(d, carry_in(borrow != 0u, words_zero(d), below));
  const Fq p = p_words();
  const uint32_t mask = 0u - below;
  Fq e;
  e.v[0] = ptx::add_cc(d.v[0], p.v[0] & mask);
#pragma unroll
  for (int k = 1; k < kS; ++k) e.v[k] = ptx::addc_cc(d.v[k], p.v[k] & mask);
  const uint32_t carry = ptx::addc(0u, 0u);
  uint32_t top;
  return add_bit(e, carry_in(carry != 0u, words_max(e), top));
}

__device__ __forceinline__ Fq neg(const Fq& a) { return sub(zero(), a); }

// z = x * y, kS x kS words -> 2 kS words: the kS^2 products are
// independent, their halves summed per column in 64 bits (below 2^35),
// then one carry pass
__device__ __forceinline__ void mul_wide(const uint32_t (&x)[kS], const uint32_t (&y)[kS],
                                         uint32_t (&z)[2 * kS]) {
  uint64_t c[2 * kS];
#pragma unroll
  for (int k = 0; k < 2 * kS; ++k) c[k] = 0u;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const uint64_t t = (uint64_t)x[j] * y[i];
      c[i + j] += (uint32_t)t;
      c[i + j + 1] += t >> 32;
    }
  }
  uint64_t carry = 0u;
#pragma unroll
  for (int k = 0; k < 2 * kS; ++k) {
    const uint64_t v = c[k] + carry;
    z[k] = (uint32_t)v;
    carry = v >> 32;
  }
}

// m = x * y mod 2^(32 kS), the same way
__device__ __forceinline__ void mul_low(const uint32_t (&x)[kS], const uint32_t (&y)[kS],
                                        uint32_t (&m)[kS]) {
  uint64_t c[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) c[k] = 0u;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
#pragma unroll
    for (int j = 0; i + j < kS; ++j) {
      const uint64_t t = (uint64_t)x[i] * y[j];
      c[i + j] += (uint32_t)t;
      if (i + j + 1 < kS) c[i + j + 1] += t >> 32;
    }
  }
  uint64_t carry = 0u;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const uint64_t v = c[k] + carry;
    m[k] = (uint32_t)v;
    carry = v >> 32;
  }
}

// Montgomery product a * b * 2^-384 mod p, equal to fp::mul. Not inlined,
// as fp::mul: the group law makes 7 to 16 products per point op.
static __device__ __noinline__ Fq mul(Fq a, Fq b) {
  const Fq p = p_words();
  uint32_t pinv[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) pinv[k] = kPInv[k];
  uint32_t bd[kT][kS];  // b's digits, from their ranks
#pragma unroll
  for (int j = 0; j < kT; ++j) {
#pragma unroll
    for (int k = 0; k < kS; ++k) bd[j][k] = from_rank(b.v[k], j);
  }
  uint32_t lo[kS], c = 0u;
#pragma unroll
  for (int k = 0; k < kS; ++k) lo[k] = 0u;
  uint32_t prod[2 * kS];
  mul_wide(a.v, bd[0], prod);
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    // W = lo + c 2^(32 kS) + a_r * b_j
    uint32_t w[2 * kS + 1];
    w[0] = ptx::add_cc(lo[0], prod[0]);
#pragma unroll
    for (int k = 1; k < kS; ++k) w[k] = ptx::addc_cc(lo[k], prod[k]);
    w[kS] = ptx::addc_cc(prod[kS], c);
#pragma unroll
    for (int k = kS + 1; k < 2 * kS; ++k) w[k] = ptx::addc_cc(prod[k], 0u);
    w[2 * kS] = ptx::addc(0u, 0u);
    // m zeroes the group's low digit (rank 0's low words)
    uint32_t x[kS], m[kS], q[2 * kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) x[k] = from_rank(w[k], 0);
    mul_low(x, pinv, m);
    mul_wide(m, p.v, q);
    w[0] = ptx::add_cc(w[0], q[0]);
#pragma unroll
    for (int k = 1; k < 2 * kS; ++k) w[k] = ptx::addc_cc(w[k], q[k]);
    w[2 * kS] = ptx::addc(w[2 * kS], 0u);
    // shift one digit down: the next round's product runs while the
    // shuffles are in flight
    uint32_t down[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) down[k] = from_above(w[k]);
    const uint32_t up = from_below(w[2 * kS]);
    if (j + 1 < kT) mul_wide(a.v, bd[(j + 1) % kT], prod);
    lo[0] = ptx::add_cc(w[kS], down[0]);
#pragma unroll
    for (int k = 1; k < kS; ++k) lo[k] = ptx::addc_cc(w[kS + k], down[k]);
    c = ptx::addc(0u, 0u);
    lo[0] = ptx::add_cc(lo[0], up);
#pragma unroll
    for (int k = 1; k < kS; ++k) lo[k] = ptx::addc_cc(lo[k], 0u);
    c = ptx::addc(c, 0u);
  }
  // the value (< 2p) is lo at each rank plus the rank below's c
  Fq s;
  s.v[0] = ptx::add_cc(lo[0], from_below(c));
#pragma unroll
  for (int k = 1; k < kS; ++k) s.v[k] = ptx::addc_cc(lo[k], 0u);
  const uint32_t carry = ptx::addc(0u, 0u);
  uint32_t top;
  s = add_bit(s, carry_in(carry != 0u, words_max(s), top));
  return reduce_once(s);
}

__device__ __forceinline__ Fq sqr(const Fq& a) { return mul(a, a); }

// -- a pair of groups (lanes 8g .. 8g + 7): two products at once ------------

// 0 in the pair's first group, 1 in its second
__device__ __forceinline__ bool second() { return (lane() / kT) & 1; }

__device__ __forceinline__ Fq sel(bool c, const Fq& a, const Fq& b) {
  Fq r;
#pragma unroll
  for (int k = 0; k < kS; ++k) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// Both groups of a pair hold xa, ya, xb, yb; the first computes xa * ya,
// the second xb * yb, and after one exchange both hold both products.
__device__ __forceinline__ void mul2(const Fq& xa, const Fq& ya, const Fq& xb, const Fq& yb,
                                     Fq& pa, Fq& pb) {
  const bool h = second();
  const Fq mine = mul(sel(h, xb, xa), sel(h, yb, ya));
  Fq other;
#pragma unroll
  for (int k = 0; k < kS; ++k) other.v[k] = __shfl_xor_sync(kWarp, mine.v[k], kT);
  pa = sel(h, other, mine);
  pb = sel(h, mine, other);
}

}  // namespace fpc
