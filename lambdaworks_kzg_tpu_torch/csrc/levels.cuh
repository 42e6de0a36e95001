// The machine of levels the pairing kernels (pairing.cu) run: one thread
// block of 224 threads (56 groups of fp_coop.cuh's four threads, 7 warps)
// works on field values in shared memory, slot s holding one Fp value as
// 12 u32 words at lv::S[12 s] (Montgomery form, fully reduced). A program
// (ops/pairing_levels.py builds and encodes it; the wrapper hands it over
// as an int32 array in device memory, and each block copies it into
// shared memory behind the slots: read from global memory, the table and
// entry reads of every phase waited on L2) is a list of subroutines, each
// a list of phases, and run() executes one subroutine phase by phase, a
// __syncthreads() after each:
//
//   MUL   up to 56 independent products, one per group of four threads
//         (fpc::mul); a warp with no product skips the phase as a whole,
//         and a group past the last product of an active warp computes
//         the last one again and keeps nothing (the warp convention of
//         fp_coop.cuh: every thread of a warp reaches each field op);
//   LIN   up to 224 linear combinations, one per thread: out = sum c_i
//         x_i mod p for small signed c_i, summed lazily (below);
//   INV   up to 7 inversions, on lane 0 of one warp each: the binary
//         extended Euclid below, then a product by R^3.
//
// The program guarantees that no entry writes a slot that another entry of
// its phase reads (a linear entry may overwrite a slot only it reads: it
// reads its terms first), and that no two entries write one slot, so the
// entries of a phase may run in any order.
//
// Encoding (int32 words; offsets as ops/pairing_levels.py's H_*): header
// [slots, phase table offset, (first phase, phase count) x 12, io slots
// x 64]; the phase table [kind, entries, entry
// offset, stride] per phase; entries: MUL a | b << 10 | o << 20; INV
// a | o << 10; LIN [o | terms << 16, then per term slot | coef << 16
// (coef a signed 16-bit int)], stride words each.
#pragma once
#include <stdint.h>

// -- the binary inverse: a^-1 mod p for a plain integer a in [0, p), 0 -> 0
// (no PTX, so the same code builds with a host compiler: the CPU tests
// hold it against Python on edge inputs) -----------------------------------
namespace binv {

constexpr int N = 12;

__host__ __device__ __forceinline__ bool is_one(const uint32_t (&x)[N]) {
  uint32_t acc = x[0] ^ 1u;
#pragma unroll
  for (int k = 1; k < N; ++k) acc |= x[k];
  return acc == 0u;
}

__host__ __device__ __forceinline__ bool is_zero(const uint32_t (&x)[N]) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) acc |= x[k];
  return acc == 0u;
}

// x = (x + top 2^384) / 2
__host__ __device__ __forceinline__ void shr1(uint32_t (&x)[N], uint32_t top) {
#pragma unroll
  for (int k = 0; k < N - 1; ++k) x[k] = (x[k] >> 1) | (x[k + 1] << 31);
  x[N - 1] = (x[N - 1] >> 1) | (top << 31);
}

// x += y, the carry out returned
__host__ __device__ __forceinline__ uint32_t add(uint32_t (&x)[N], const uint32_t (&y)[N]) {
  uint64_t c = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    c += (uint64_t)x[k] + y[k];
    x[k] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// x -= y, the borrow out returned
__host__ __device__ __forceinline__ uint32_t sub(uint32_t (&x)[N], const uint32_t (&y)[N]) {
  uint32_t b = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t d = (uint64_t)x[k] - y[k] - b;
    x[k] = (uint32_t)d;
    b = (uint32_t)(d >> 32) & 1u;
  }
  return b;
}

__host__ __device__ __forceinline__ bool geq(const uint32_t (&x)[N], const uint32_t (&y)[N]) {
  bool decided = false, ge = true;
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    if (!decided && x[k] != y[k]) {
      ge = x[k] > y[k];
      decided = true;
    }
  }
  return ge;
}

// x / 2 mod p for x in [0, p)
__host__ __device__ __forceinline__ void half(uint32_t (&x)[N], const uint32_t (&p)[N]) {
  uint32_t top = 0u;
  if (x[0] & 1u) top = add(x, p);
  shr1(x, top);
}

// x - y mod p for x, y in [0, p)
__host__ __device__ __forceinline__ void sub_mod(uint32_t (&x)[N], const uint32_t (&y)[N],
                                                 const uint32_t (&p)[N]) {
  if (sub(x, y)) add(x, p);
}

// The binary extended Euclid for an odd p (u = x1 a, v = x2 a mod p at
// every step): ~2 x 381 halvings and ~381 subtractions of 12-word values,
// tens of us on one thread, where a Fermat chain is ~460 dependent
// products. The running time depends on a (public values here).
__host__ __device__ inline void inverse(const uint32_t (&a)[N], const uint32_t (&p)[N],
                                        uint32_t (&out)[N]) {
  uint32_t u[N], v[N], x1[N], x2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    u[k] = a[k];
    v[k] = p[k];
    x1[k] = k == 0 ? 1u : 0u;
    x2[k] = 0u;
  }
  if (is_zero(u)) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = 0u;
    return;
  }
  while (!is_one(u) && !is_one(v)) {
    while (!(u[0] & 1u)) {
      shr1(u, 0u);
      half(x1, p);
    }
    while (!(v[0] & 1u)) {
      shr1(v, 0u);
      half(x2, p);
    }
    if (geq(u, v)) {
      sub(u, v);
      sub_mod(x1, x2, p);
    } else {
      sub(v, u);
      sub_mod(x2, x1, p);
    }
  }
  const bool first = is_one(u);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = first ? x1[k] : x2[k];
}

}  // namespace binv

#ifdef __CUDACC__
#include "fp.cuh"
#include "fp_coop.cuh"

namespace lv {

constexpr int kThreads = 224;
constexpr int kGroups = kThreads / fpc::kT;
constexpr int kWords = fp::NL;
enum : int { kMul = 1, kLin = 2, kInv = 3 };
// header offsets (ops/pairing_levels.py)
constexpr int kHeaderSlots = 0, kHeaderTable = 1, kHeaderSubs = 2, kHeaderIo = 26;

// the kernel's dynamic shared memory: the slots, then the program from word
// po = slots * 12 on (the wrapper sizes it); a slot is 48 bytes, so each
// starts on 16 bytes and loads as three uint4
extern __shared__ __align__(16) uint32_t S[];

// program word i
__device__ __forceinline__ int pw(int po, int i) { return (int)S[po + i]; }

// copy the program into shared memory; returns po. The caller syncs.
__device__ __forceinline__ int load_program(const int32_t* __restrict__ prog, int words) {
  const int po = __ldg(prog + kHeaderSlots) * fp::NL;
  for (int i = threadIdx.x; i < words; i += blockDim.x) S[po + i] = (uint32_t)__ldg(prog + i);
  return po;
}

// R^3 mod p: A^-1 R^3 / R = (a R)^-1 R^2 = a^-1 R, the Montgomery inverse
static __constant__ fp::Fp kR3 = {{0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu,
                                   0x615e29ddu, 0x9a53352au, 0x921e1761u, 0x34c04e5eu,
                                   0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u}};

__device__ __forceinline__ int io(int po, int i) { return pw(po, kHeaderIo + i); }

__device__ __forceinline__ fp::Fp ld(int s) {
  const uint4* q = reinterpret_cast<const uint4*>(S + s * kWords);
  fp::Fp a;
#pragma unroll
  for (int j = 0; j < kWords / 4; ++j) {
    const uint4 x = q[j];
    a.v[4 * j] = x.x;
    a.v[4 * j + 1] = x.y;
    a.v[4 * j + 2] = x.z;
    a.v[4 * j + 3] = x.w;
  }
  return a;
}

__device__ __forceinline__ void st(int s, const fp::Fp& a) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) S[s * kWords + k] = a.v[k];
}

// this rank's words of slot s
__device__ __forceinline__ fpc::Fq ldc(int s) {
  fpc::Fq a;
  const int o = s * kWords + fpc::rank() * fpc::kS;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) a.v[k] = S[o + k];
  return a;
}

__device__ __forceinline__ void stc(int s, const fpc::Fq& a) {
  const int o = s * kWords + fpc::rank() * fpc::kS;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) S[o + k] = a.v[k];
}

// e: the word of the phase's first entry in S
__device__ __forceinline__ void mul_phase(int e, int n) {
  if ((int)(threadIdx.x >> 5) * (32 / fpc::kT) >= n) return;  // the warp has no product
  const int g = threadIdx.x / fpc::kT;
  const uint32_t w = S[e + (g < n ? g : n - 1)];
  const fpc::Fq r = fpc::mul(ldc(w & 1023u), ldc((w >> 10) & 1023u));
  if (g < n) stc(w >> 20, r);
}

// 2p, for the last reduction of a linear combination
static __constant__ fp::Fp k2P = {{0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
                                   0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
                                   0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u}};
// 1 / (p_top + 1), p_top = p >> 352 = 0x1a0111ea: floor(V / 2^352 * this)
// - 1 is at most floor(V / p), and V - that p is below 4p
constexpr double kInvPTop = 1.0 / 436277739.0;

// a - m where a >= m, else a (a, m below 2^384)
__device__ __forceinline__ fp::Fp sub_if_ge(const fp::Fp& a, const fp::Fp& m) {
  fp::Fp d;
  d.v[0] = fp::ptx::sub_cc(a.v[0], m.v[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) d.v[k] = fp::ptx::subc_cc(a.v[k], m.v[k]);
  const uint32_t borrow = fp::ptx::subc(0u, 0u);  // all ones when a < m
#pragma unroll
  for (int k = 0; k < kWords; ++k) d.v[k] = (a.v[k] & borrow) | (d.v[k] & ~borrow);
  return d;
}

// out = sum c_i x_i mod p, lazily. Each term adds |c_i| times each word of
// x_i (c_i > 0) or of ~x_i = 2^384 - 1 - x_i (c_i < 0) into an unsigned
// 64-bit sum per word: one multiply-add per word, independent across
// words and branch-free (sum |c_i| < 2^19 keeps each sum below 2^52).
// With n = the sum of the negative |c_i|, that is V' = sum c_i x_i +
// n (2^384 - 1); adding n (p + 1) and taking n off the word above the top
// leaves V = sum c_i x_i + n p >= 0, below 2^401 in 13 words after one
// carry pass. q from its top 50 bits (a double product, one less) is at
// most floor(V / p), V - q p is below 4p, and two conditional
// subtractions (2p, then p) leave V mod p.
__device__ __forceinline__ void lin_phase(int e, int n, int stride) {
  const int t = threadIdx.x;
  if (t >= n) return;
  const int ent = e + t * stride;
  const uint32_t h = S[ent];
  const int nt = h >> 16;
  uint64_t acc[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) acc[w] = 0u;
  uint32_t neg = 0u;
  // four terms in flight: each term's loads wait on its term word
#pragma unroll 4
  for (int i = 0; i < nt; ++i) {
    const uint32_t tw = S[ent + 1 + i];
    const int k = (int16_t)(tw >> 16);
    const uint32_t a = k < 0 ? -k : k, flip = k < 0 ? ~0u : 0u;
    const fp::Fp x = ld(tw & 0xffffu);
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc[w] += (uint64_t)a * (x.v[w] ^ flip);
    neg += k < 0 ? a : 0u;
  }
  uint32_t v[kWords + 1];
  uint64_t c = neg;  // the n of n (p + 1)
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const uint64_t x = acc[w] + (uint64_t)neg * fp::kP.v[w] + c;
    v[w] = (uint32_t)x;
    c = x >> 32;
  }
  v[kWords] = (uint32_t)c - neg;
  const uint64_t top = ((uint64_t)v[kWords] << 32) | v[kWords - 1];
  uint32_t q = (uint32_t)__double2uint_rz((double)top * kInvPTop);
  q = q ? q - 1u : 0u;
  fp::Fp r;
  int64_t b = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int64_t x = (int64_t)v[w] - (int64_t)q * fp::kP.v[w] + b;
    r.v[w] = (uint32_t)x;
    b = x >> 32;
  }
  st(h & 0xffffu, sub_if_ge(sub_if_ge(r, k2P), fp::kP));
}

__device__ __forceinline__ void inv_phase(int e, int n) {
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || w >= n) return;
  const uint32_t ent = S[e + w];
  const fp::Fp a = ld(ent & 1023u);
  uint32_t p[binv::N];
#pragma unroll
  for (int k = 0; k < binv::N; ++k) p[k] = fp::kP.v[k];
  fp::Fp r;
  binv::inverse(a.v, p, r.v);
  st(ent >> 10, fp::mul(r, kR3));
}

// one subroutine of the program (inlined: as a call, the loop state of the
// Miller kernel spilled across it)
__device__ __forceinline__ void run(int po, int sub) {
  const int first = pw(po, kHeaderSubs + 2 * sub);
  const int count = pw(po, kHeaderSubs + 2 * sub + 1);
  const int table = po + pw(po, kHeaderTable);
#pragma unroll 1
  for (int i = first; i < first + count; ++i) {
    const int kind = (int)S[table + 4 * i], n = (int)S[table + 4 * i + 1];
    const int e = po + (int)S[table + 4 * i + 2];
    if (kind == kMul)
      mul_phase(e, n);
    else if (kind == kLin)
      lin_phase(e, n, (int)S[table + 4 * i + 3]);
    else
      inv_phase(e, n);
    __syncthreads();
  }
}

}  // namespace lv
#endif
