// Batched G1 kernels for Hopper (sm_90a): g1_decompress, g1_scalar_mul and
// g1_subgroup_mask, the setup conversion's and the batch verification's
// point steps.
//
// They replace the per-step launches of the TPU kernels add and dbl of
// lambdaworks_kzg_tpu/ops/pallas_g1_v2.py (_add_kernel, _dbl_kernel), which
// lambdaworks_kzg_tpu/ops/g1_batch.py drives from XLA fori_loops, one
// pallas_call per step, and the XLA field ops around them:
//   g1_decompress    <- _xy_from_x + _pick_sign (:156, :169): rhs = x^3 + 4,
//                       y0 = rhs^((p+1)/4), qr = (y0^2 == rhs), and y0 or
//                       p - y0 so that "y > (p-1)/2" matches the sign bit;
//   g1_scalar_mul    <- scalar_mul_fixed (:45) and scalar_mul_per_lane
//                       (:67): right-to-left double-and-add over the
//                       complete add, the whole loop in one launch;
//   g1_subgroup_mask <- subgroup_mask (:126) with _jacobian_eq_mask: two
//                       multiplications by |x| (64 bits) and the
//                       cross-multiplied test sigma(P) == -[x^2]P.
// Their plain versions are ops/g1_ops.py decompress_xy, scalar_mul and
// subgroup_mask.
//
// Layout as g1.cu: limbs-first u32 arrays in Montgomery form, [12, M] for
// an Fp value, [3, 12, M] Jacobian; scalars [8, M] plain u32 words, or
// [8, 1] with k_stride 0 for one scalar on every lane; bools as uint8.
//
// Design: one thread per lane with its whole chain in registers, blocks of
// one warp, so an FFT stage's 2048 lanes spread over 64 SMs. The group law
// is g1.cuh's, in the plain versions' order with their exceptional lanes,
// so every output equals the plain version limb for limb. A lane's loop
// ends at its scalar's highest set bit: the accumulator does not change
// after it. The square root's power has one fixed value, so its chain
// (left to right over (p+1)/4) need not be the plain version's.
//
// What bounds them: the operations. g1_scalar_mul on a 255-bit scalar runs
// ~254 doublings and ~128 adds, ~3,900 Montgomery products and squarings
// in one dependent chain per lane, against 320 bytes in and 144 out;
// g1_decompress a 379-bit power (378 squarings, 189 products) against 49
// bytes in and 49 out; g1_subgroup_mask 126 doublings and 12 adds against
// 144 bytes in. At the path's 2048 to 4096 lanes a launch holds at most
// one warp per SM sub-partition, so one thread's chain latency, not the
// card's multiply rate, sets its time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"

namespace {

using fp::Fp;
using g1::Jac;

constexpr int kThreads = 32;
constexpr int kScalarWords = 8;

// (p + 1) / 4: 379 bits, the top set bit is bit 26 of word 11
__constant__ Fp kSqrtExp = {{0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu,
                             0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u,
                             0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au}};
constexpr int kSqrtTopBit = 26;
// (p - 1) / 2, plain
__constant__ Fp kHalf = {{0xffffd555u, 0xdcff7fffu, 0x58a9ffffu, 0x0f55ffffu,
                          0x7b587b12u, 0xb3986950u, 0x79c2895fu, 0xb23ba5c2u,
                          0x21a5d66bu, 0x258dd3dbu, 0x1cbff34du, 0x0d0088f5u}};
// the curve's b = 4 and the cube root of unity BETA, Montgomery form
__constant__ Fp kB = {{0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u,
                       0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu,
                       0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u}};
__constant__ Fp kBeta = {{0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu,
                          0xc61577f7u, 0x16a8ca3au, 0x74fd029bu, 0xc26a2ff8u,
                          0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu}};
// |x| = 0xd201000000010000, the BLS parameter's absolute value
constexpr uint32_t kXAbsLo = 0x00010000u;
constexpr uint32_t kXAbsHi = 0xd2010000u;

__device__ __forceinline__ bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t d = 0u;
#pragma unroll
  for (int k = 0; k < fp::NL; ++k) d |= a.v[k] ^ b.v[k];
  return d == 0u;
}

// a > b for values below 2^384, from the top word down
__device__ __forceinline__ bool fp_gt(const Fp& a, const Fp& b) {
  bool gt = false, decided = false;
#pragma unroll
  for (int k = fp::NL - 1; k >= 0; --k) {
    if (!decided && a.v[k] != b.v[k]) {
      gt = a.v[k] > b.v[k];
      decided = true;
    }
  }
  return gt;
}

// a^((p+1)/4), left to right from the bit below the top one; 0 -> 0
__device__ __noinline__ Fp pow_sqrt(Fp a) {
  Fp r = a;
#pragma unroll 1
  for (int w = fp::NL - 1; w >= 0; --w) {
    const uint32_t e = kSqrtExp.v[w];
#pragma unroll 1
    for (int bit = w == fp::NL - 1 ? kSqrtTopBit - 1 : 31; bit >= 0; --bit) {
      r = fp::sqr(r);
      if ((e >> bit) & 1u) r = fp::mul(r, a);
    }
  }
  return r;
}

// [k] base for the NW-word scalar s, right to left as the plain version:
// from acc at infinity, for each bit up to the highest set one,
// acc = jac_add(acc, base) where the bit is set, then base = jac_dbl(base)
// while a set bit is left above.
template <int NW>
__device__ __forceinline__ Jac scalar_mul_words(Jac base, const uint32_t (&s)[NW]) {
  int top = -1;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (s[j]) top = 32 * j + 31 - __clz((int)s[j]);
  Jac acc = g1::jac_zero();
#pragma unroll 1
  for (int i = 0; i <= top; ++i) {
    uint32_t word = 0u;  // s[i / 32], selected without a dynamic index
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j == (i >> 5)) word = s[j];
    if ((word >> (i & 31)) & 1u) acc = g1::jac_add(acc, base);
    if (i < top) base = g1::jac_dbl(base);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    g1_decompress_kernel(const uint32_t* __restrict__ x_in,
                         const uint8_t* __restrict__ want_largest,
                         uint32_t* __restrict__ y_out,
                         uint8_t* __restrict__ qr_out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Fp x = fp::load(x_in, M, m);
  const Fp b = kB;
  const Fp rhs = fp::add(fp::mul(fp::sqr(x), x), b);
  const Fp y0 = pow_sqrt(rhs);
  qr_out[m] = fp_eq(fp::sqr(y0), rhs) ? 1 : 0;
  Fp one_plain = fp::zero();  // y0 * 1 / R: y0 out of Montgomery form
  one_plain.v[0] = 1u;
  const Fp half = kHalf;
  const bool largest = fp_gt(fp::mul(y0, one_plain), half);
  const bool flip = largest != (want_largest[m] != 0);
  fp::store(y_out, M, m, flip ? fp::sub(fp::zero(), y0) : y0);
}

__global__ void __launch_bounds__(kThreads)
    g1_scalar_mul_kernel(const uint32_t* __restrict__ p,
                         const uint32_t* __restrict__ k, int k_stride,
                         uint32_t* __restrict__ out, int M, int nbits) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t row = k_stride ? (size_t)M : 1;
  const size_t col = k_stride ? (size_t)m : 0;
  uint32_t s[kScalarWords];
#pragma unroll
  for (int j = 0; j < kScalarWords; ++j) {
    uint32_t w = k[j * row + col];
    const int lo = 32 * j;  // bits at or above nbits are not read
    if (nbits <= lo) w = 0u;
    else if (nbits < lo + 32) w &= (1u << (nbits - lo)) - 1u;
    s[j] = w;
  }
  g1::store_jac(out, M, m, scalar_mul_words(g1::load_jac(p, M, m), s));
}

__global__ void __launch_bounds__(kThreads)
    g1_subgroup_mask_kernel(const uint32_t* __restrict__ p,
                            uint8_t* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Jac P = g1::load_jac(p, M, m);
  const uint32_t x_abs[2] = {kXAbsLo, kXAbsHi};
  Jac xx = P;
#pragma unroll 1
  for (int r = 0; r < 2; ++r) xx = scalar_mul_words(xx, x_abs);
  // sigma(P) = (BETA X, Y, Z) against -[x^2]P = (X', -Y', Z')
  const Fp beta = kBeta;
  const Fp X1 = fp::mul(P.X, beta);
  const Fp Y2 = fp::sub(fp::zero(), xx.Y);
  const Fp Z11 = fp::sqr(P.Z);
  const Fp Z22 = fp::sqr(xx.Z);
  const bool ex = fp_eq(fp::mul(X1, Z22), fp::mul(xx.X, Z11));
  const bool ey = fp_eq(fp::mul(fp::mul(P.Y, xx.Z), Z22), fp::mul(fp::mul(Y2, P.Z), Z11));
  const bool inf1 = fp::is_zero(P.Z);
  const bool inf2 = fp::is_zero(xx.Z);
  out[m] = (inf1 || inf2) ? (inf1 == inf2) : (ex && ey);
}

inline int blocks_for(int M) { return (M + kThreads - 1) / kThreads; }

}  // namespace

// Launchers: raw device pointers, the lane count M and a cudaStream_t.
// Each returns cudaGetLastError() after its launch (0 on success).
extern "C" int lwkzg_g1_decompress(const void* x, const void* want_largest,
                                   void* y, void* qr, int M, void* stream) {
  g1_decompress_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint8_t*)want_largest, (uint32_t*)y,
      (uint8_t*)qr, M);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_g1_scalar_mul(const void* p, const void* k, int k_stride,
                                   void* out, int M, int nbits, void* stream) {
  g1_scalar_mul_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)k, k_stride, (uint32_t*)out, M,
      nbits);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_g1_subgroup_mask(const void* p, void* out, int M,
                                      void* stream) {
  g1_subgroup_mask_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint8_t*)out, M);
  return (int)cudaGetLastError();
}
