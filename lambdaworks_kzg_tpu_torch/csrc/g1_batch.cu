// Batched G1 kernels for Hopper (sm_90a): g1_decompress, g1_scalar_mul,
// g1_fft_stage and g1_subgroup_mask, the setup conversion's and the batch
// verification's point steps; g1_fold, the mesh's fold of the shards'
// partials, and g1_add, the same fold of two rows; and fp_coop_check,
// which holds the cooperative field (fp_coop.cuh) against fp.cuh.
//
// They replace the per-step launches of the TPU kernels add and dbl of
// lambdaworks_kzg_tpu/ops/pallas_g1_v2.py (_add_kernel, _dbl_kernel), which
// lambdaworks_kzg_tpu/ops/g1_batch.py drives from XLA fori_loops, one
// pallas_call per step, and the XLA field ops around them:
//   g1_decompress    <- _xy_from_x + _pick_sign (:156, :169): rhs = x^3 + 4,
//                       y0 = rhs^((p+1)/4), qr = (y0^2 == rhs), and y0 or
//                       p - y0 so that "y > (p-1)/2" matches the sign bit;
//   g1_scalar_mul    <- scalar_mul_fixed (:45) and scalar_mul_per_lane (:67),
//                       the loops of the G1 FFT (g1_fft_device :241):
//                       right-to-left double-and-add over the complete add,
//                       the whole loop in one launch; and, for points known
//                       to lie in G1, a split mode (below);
//   g1_fft_stage     <- one stage of g1_fft_device's loop (:270-272): the
//                       per-lane scalar multiplication of the odd half by
//                       its twiddles and the two adds of the butterflies,
//                       in one launch, for points known to lie in G1;
//   g1_subgroup_mask <- subgroup_mask (:126) with _jacobian_eq_mask: two
//                       multiplications by |x| (64 bits) and the
//                       cross-multiplied test sigma(P) == -[x^2]P;
//   g1_fold          <- the add launches of lambdaworks_kzg_tpu/parallel/
//                       msm.py _tree_fold_points (:40), one per level:
//                       K rows of Jacobian points folded into one, every
//                       level in one launch;
//   g1_add           <- add (pallas_g1_v2.py :376) itself: g1_fold's body
//                       on two rows in the u32 layout.
// Their plain versions are ops/g1_ops.py decompress_xy, scalar_mul,
// scalar_mul_endo, fft_stage_endo, subgroup_mask, fold and add.
//
// Layout as g1.cu: limbs-first u32 arrays in Montgomery form, [12, M] for
// an Fp value, [3, 12, M] Jacobian; scalars [8, M] plain u32 words, or
// [8, 1] with k_stride 0 for one scalar on every lane; bools as uint8.
// g1_fold reads and writes the public layout instead, int64 radix-2^16
// limbs [K, 3, 24, B] in and [3, 24, B] out, as the mesh holds its
// partials, so no conversion runs around it.
//
// What bounds them: the operations, in chains. g1_scalar_mul on a 255-bit
// scalar runs ~254 doublings and ~128 adds per lane; g1_subgroup_mask 126
// doublings and 10 adds (~1,170 Montgomery products); g1_decompress a
// 379-bit power (~460 products). A product is 588 dependent multiply-adds
// in one thread (~2,900 cycles on an H100), a lane's products depend on
// each other, and
// the path gives few lanes: an FFT stage 2048, the subgroup check 4096 in
// a conversion and 12 to 128 in a batch verification. So one thread per
// lane (the first design) left the card's 528 SM sub-partitions with under
// one warp each, waiting on one chain's latency: 34x, 12x and 15x the
// bounds.
//
// Design of g1_scalar_mul, g1_fft_stage and g1_subgroup_mask, against the
// chain:
//   - a group of fpc::kT = 4 threads shares every field element and every
//     product (fp_coop.cuh): ~1,570 cycles a product against ~2,900;
//   - two groups (a pair, 8 threads) share every point op: both hold the
//     operands and each computes one of two independent products
//     (fpc::mul2), so a doubling is 4 products deep instead of 8 and an
//     add 8 instead of 16;
//   - so a lane has 8 threads (16 in the split mode and the FFT stage),
//     and blocks hold 64 threads, two warps: an FFT stage (2048 lanes)
//     and a conversion's subgroup check (4096 lanes) make 1024 warps each.
// Every thread of a warp runs every field op (the shuffles and ballots
// name the whole warp): a branch on one lane's data (a scalar bit, a point
// at infinity, the same-x fixups) is a select, or a branch on a warp-wide
// any. The group law is g1.cuh's, with the plain versions' values, order
// and exceptional lanes, so every output equals the plain version limb for
// limb. A ladder runs to the highest set bit of any lane of the warp: a
// lane's accumulator does not change after its own.
//
// The split mode of g1_scalar_mul serves only the setup conversion's FFT,
// whose points have passed the subgroup check. For P in G1, sigma(P) =
// (BETA X, Y, Z) = -[x^2]P (the identity g1_subgroup_mask tests), so with
// k = k1 + k2 x^2 (k1 < x^2, k2 < 2^128, split on the host) the kernel
// computes [k1]P + [k2]sigma'(P), sigma'(P) = (BETA X, -Y, Z) = [x^2]P.
// Two pairs run the two 128-bit halves side by side, each left to right
// in 4-bit windows over a table 0, P, .., 15P in shared memory (7
// doublings and 7 adds to build, then 124 doublings and 31 adds): ~1,540
// products in a lane's chain against ~5,840 for the general ladder, whose
// warps run the add on nearly every step. Then the second pair hands its
// point to the first, which adds. On a point outside G1 the split gives
// another point than [k]P; the general mode stays for every other caller.
//
// g1_fft_stage runs the split mode on the odd half of one FFT stage and
// the butterflies after it: the first pair's sum t goes back to the second
// pair, and the first pair computes even + t while the second computes
// even + (X_t, -Y_t, Z_t), so a stage is one launch and one add deeper than
// the split mode alone. It reads the stage's input and writes another
// array (ping-pong), in the natural order, so no layout step sits between
// stages.
//
// g1_fold and g1_add: a pair per add, so an add is 8 products deep at
// ~1,570 cycles, against 16 at ~2,900 for one thread on fp.cuh. What bounds
// them is that chain: a mesh's fold has a handful of columns (6 to 12),
// far too few lanes to fill the card. A column (a lane of the K rows) has
// up to 8 pairs: the adds of one level run side by side, each level's sums
// wait in shared memory behind a barrier for the next, in the plain fold's
// order (row j plus row half + j; an odd last row waits a level), and the
// last sum is stored, so K rows take ceil(log2 K) adds in one launch.
//
// g1_decompress: one group of fpc::kT threads per lane, since a lane's one
// chain (the power) gives a pair no second product. The exponent (p+1)/4
// is the same on every lane, so a sliding window of 5 bits over the odd
// powers a, a^3, .., a^31 (in shared memory) branches alike on every lane:
// 376 squarings and 81 products against the 1-bit chain's 378 and 228.
// The sign choice takes y0 out of Montgomery form with one product by 1
// and compares it with (p-1)/2 across the group (fpc::gt).
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1_coop.cuh"

namespace {

using namespace g1c;

using fp::Fp;
using fpc::Fq;

constexpr int kBlock = 64;  // 16 groups of fpc::kT
constexpr int kPair = 2 * fpc::kT;  // threads per lane: a pair of groups
constexpr int kScalarWords = 8;
constexpr int kHalfWords = 4;  // one half of a split scalar: 128 bits
constexpr int kWindow = 4;
constexpr int kTable = 1 << kWindow;
constexpr int kCoords = 3 * fpc::kS;  // a thread's words of a Jacobian point

// (p + 1) / 4: 379 bits, the top set bit is bit 26 of word 11
constexpr int kSqrtBits = 32 * (fp::NL - 1) + 27;
__constant__ Fp kSqrtExp = {{0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu,
                             0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u,
                             0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au}};
constexpr int kPowWindow = 5;  // the square root's sliding window
constexpr int kPowTable = 1 << (kPowWindow - 1);  // a, a^3, .., a^31
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

// [k] base for the NW-word scalar s, right to left as the plain version:
// from acc at infinity, for each bit up to the highest set one of any
// lane of the warp, acc = add(acc, base) where the bit is set, then
// base = dbl(base) while a set bit is left above (acc does not change
// after a lane's own highest bit).
template <int NW>
__device__ __forceinline__ CJac ladder(CJac base, const uint32_t (&s)[NW]) {
  int top = -1;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (s[j]) top = 32 * j + 31 - __clz((int)s[j]);
  top = __reduce_max_sync(fpc::kWarp, top);  // the same loop on every lane
  CJac acc = cjac_zero();
#pragma unroll 1
  for (int i = 0; i <= top; ++i) {
    uint32_t word = 0u;  // s[i / 32], selected without a dynamic index
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j == (i >> 5)) word = s[j];
    const bool bit = (word >> (i & 31)) & 1u;
    if (fpc::warp_any(bit)) acc = csel(bit, cjac_add(acc, base), acc);
    if (i < top) base = cjac_dbl(base);
  }
  return acc;
}

// The window table: entry e's words of this thread at tab[e][0 .. 8][tid],
// so a warp's 32 threads touch 32 banks whatever entry each group reads.
using Table = uint32_t (*)[kCoords][kBlock];

__device__ __forceinline__ void put(Table tab, int e, const CJac& P) {
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    tab[e][k][threadIdx.x] = P.X.v[k];
    tab[e][fpc::kS + k][threadIdx.x] = P.Y.v[k];
    tab[e][2 * fpc::kS + k][threadIdx.x] = P.Z.v[k];
  }
}

__device__ __forceinline__ CJac get(Table tab, int e) {
  CJac P;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    P.X.v[k] = tab[e][k][threadIdx.x];
    P.Y.v[k] = tab[e][fpc::kS + k][threadIdx.x];
    P.Z.v[k] = tab[e][2 * fpc::kS + k][threadIdx.x];
  }
  return P;
}

// window w (bits 4w .. 4w + 3) of a 128-bit scalar
__device__ __forceinline__ int digit(const uint32_t (&s)[kHalfWords], int w) {
  uint32_t word = 0u;
#pragma unroll
  for (int j = 0; j < kHalfWords; ++j)
    if (j == (w >> 3)) word = s[j];
  return (int)((word >> ((w & 7) * kWindow)) & (kTable - 1));
}

// [s] P for a 128-bit s, left to right in 4-bit windows, as the plain
// g1_ops.window_mul: the table T[0] = infinity, T[1] = P, T[2j] =
// dbl(T[j]), T[2j+1] = add(T[2j], P); acc = T[top digit], then per window
// four doublings and acc = add(acc, T[digit]).
__device__ __forceinline__ CJac window_mul(const CJac& P, const uint32_t (&s)[kHalfWords],
                                           Table tab) {
  put(tab, 0, cjac_zero());
  put(tab, 1, P);
#pragma unroll 1
  for (int j = 1; j < kTable / 2; ++j) {
    const CJac d = cjac_dbl(get(tab, j));
    put(tab, 2 * j, d);
    put(tab, 2 * j + 1, cjac_add(d, P));
  }
  constexpr int kWindows = 32 * kHalfWords / kWindow;
  CJac acc = get(tab, digit(s, kWindows - 1));
#pragma unroll 1
  for (int w = kWindows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int d = 0; d < kWindow; ++d) acc = cjac_dbl(acc);
    acc = cjac_add(acc, get(tab, digit(s, w)));
  }
  return acc;
}

// Lane of thread t for `per` threads per lane: threads past the last lane
// compute lane M - 1 again (every thread of a warp takes part in its
// shuffles) and store nothing.
__device__ __forceinline__ int lane_of(int per, int M, bool& live) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / per;
  live = m < M;
  return live ? m : M - 1;
}

// The power table of g1_decompress: odd power a^(2e+1) of this thread's
// words at tab[e][0 .. 2][tid], one thread's own column as in Table.
using PowTable = uint32_t (*)[fpc::kS][kBlock];

__device__ __forceinline__ uint32_t sqrt_exp_bit(int i) {
  return (kSqrtExp.v[i >> 5] >> (i & 31)) & 1u;
}

// a^((p+1)/4), left to right in sliding windows of up to kPowWindow bits
// (each ends in a set bit) over a, a^3, .., a^31: per window its squarings
// and one product by the table, a zero bit between windows one squaring.
// Every branch depends on the exponent alone, the same on every lane.
__device__ __forceinline__ Fq pow_sqrt(const Fq& a, PowTable tab) {
  const Fq a2 = fpc::sqr(a);
  Fq r = a;
#pragma unroll 1
  for (int e = 0; e < kPowTable; ++e) {
    if (e) r = fpc::mul(r, a2);
#pragma unroll
    for (int k = 0; k < fpc::kS; ++k) tab[e][k][threadIdx.x] = r.v[k];
  }
  bool first = true;
#pragma unroll 1
  for (int i = kSqrtBits - 1; i >= 0;) {
    if (!sqrt_exp_bit(i)) {
      r = fpc::sqr(r);
      --i;
      continue;
    }
    int j = i - kPowWindow + 1 > 0 ? i - kPowWindow + 1 : 0;
    while (!sqrt_exp_bit(j)) ++j;  // the window is bits i .. j, bit j set
    uint32_t w = 0u;
    for (int b = i; b >= j; --b) w = w << 1 | sqrt_exp_bit(b);
    Fq t;
#pragma unroll
    for (int k = 0; k < fpc::kS; ++k) t.v[k] = tab[w >> 1][k][threadIdx.x];
    if (first) {
      r = t;
    } else {
#pragma unroll 1
      for (int b = i; b >= j; --b) r = fpc::sqr(r);
      r = fpc::mul(r, t);
    }
    first = false;
    i = j - 1;
  }
  return r;
}

// One group of fpc::kT threads per lane.
__global__ void __launch_bounds__(kBlock)
    g1_decompress_kernel(const uint32_t* __restrict__ x_in,
                         const uint8_t* __restrict__ want_largest,
                         uint32_t* __restrict__ y_out,
                         uint8_t* __restrict__ qr_out, int M) {
  __shared__ uint32_t tab[kPowTable][fpc::kS][kBlock];
  bool live;
  const int m = lane_of(fpc::kT, M, live);
  const Fq x = fpc::load(x_in, M, m);
  const Fq rhs = fpc::add(fpc::mul(fpc::sqr(x), x), fpc::words_of(kB));
  const Fq y0 = pow_sqrt(rhs, tab);
  const bool qr = fpc::eq(fpc::sqr(y0), rhs);
  Fq one = fpc::zero();  // y0 * 1 / R: y0 out of Montgomery form
  one.v[0] = fpc::rank() == 0 ? 1u : 0u;
  const bool largest = fpc::gt(fpc::mul(y0, one), fpc::words_of(kHalf));
  const Fq ny = fpc::neg(y0);
  const bool flip = largest != (want_largest[m] != 0);
  if (!live) return;
  fpc::store(y_out, M, m, fpc::sel(flip, ny, y0));
  if (fpc::rank() == 0) qr_out[m] = qr ? 1 : 0;
}

__global__ void __launch_bounds__(kBlock)
    g1_scalar_mul_kernel(const uint32_t* __restrict__ p,
                         const uint32_t* __restrict__ k, int k_stride,
                         uint32_t* __restrict__ out, int M, int nbits) {
  bool live;
  const int m = lane_of(kPair, M, live);
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
  const CJac r = ladder(load_cjac(p, M, m), s);
  if (live && !fpc::second()) store_cjac(out, M, m, r);
}

// Split mode, [k]P for P in G1 on a lane of two pairs of groups: words
// 0-3 of the scalar (column col of k, rows `row` apart) hold k1, words 4-7
// k2; the first pair (half 0) computes [k1]P, the second [k2]sigma'(P),
// and the first adds them. The sum is right in the first pair only.
__device__ __forceinline__ CJac split_mul(CJac P, const uint32_t* __restrict__ k, size_t row,
                                          size_t col, bool half, Table tab) {
  uint32_t s[kHalfWords];
#pragma unroll
  for (int j = 0; j < kHalfWords; ++j) s[j] = k[(kHalfWords * half + j) * row + col];
  const Fq bx = fpc::mul(P.X, fpc::words_of(kBeta));  // sigma'(P) = (BETA X, -Y, Z)
  const Fq ny = fpc::neg(P.Y);
#pragma unroll
  for (int j = 0; j < fpc::kS; ++j) {
    P.X.v[j] = half ? bx.v[j] : P.X.v[j];
    P.Y.v[j] = half ? ny.v[j] : P.Y.v[j];
  }
  const CJac r = window_mul(P, s, tab);
  CJac other;  // the second pair's point, at the same thread of the first
#pragma unroll
  for (int j = 0; j < fpc::kS; ++j) {
    other.X.v[j] = __shfl_down_sync(fpc::kWarp, r.X.v[j], kPair, 2 * kPair);
    other.Y.v[j] = __shfl_down_sync(fpc::kWarp, r.Y.v[j], kPair, 2 * kPair);
    other.Z.v[j] = __shfl_down_sync(fpc::kWarp, r.Z.v[j], kPair, 2 * kPair);
  }
  return cjac_add(r, other);
}

__global__ void __launch_bounds__(kBlock)
    g1_scalar_mul_split_kernel(const uint32_t* __restrict__ p,
                               const uint32_t* __restrict__ k, int k_stride,
                               uint32_t* __restrict__ out, int M) {
  __shared__ uint32_t tab[kTable][kCoords][kBlock];
  bool live;
  const int m = lane_of(2 * kPair, M, live);
  const bool half = (threadIdx.x / kPair) & 1;
  const CJac sum = split_mul(load_cjac(p, M, m), k, k_stride ? (size_t)M : 1,
                             k_stride ? (size_t)m : 0, half, tab);
  if (live && !half && !fpc::second()) store_cjac(out, M, m, sum);
}

// One stage of length 2h of the conversion's FFT over n points of G1 in
// natural order: butterfly j < n/2 reads even = a[e], e = (j / h) 2h +
// j % h, and odd = a[e + h], computes t = [w_j]odd in the split mode
// (twiddle j's k1, k2 in column j of k [8, n/2]), hands t to the second
// pair, and the first pair writes even + t at e while the second writes
// even + (X_t, -Y_t, Z_t) at e + h.
__global__ void __launch_bounds__(kBlock)
    g1_fft_stage_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ k,
                        uint32_t* __restrict__ out, int n, int h) {
  __shared__ uint32_t tab[kTable][kCoords][kBlock];
  bool live;
  const int half_n = n / 2;
  const int j = lane_of(2 * kPair, half_n, live);
  const bool half = (threadIdx.x / kPair) & 1;
  const int e = ((j & ~(h - 1)) << 1) | (j & (h - 1));
  const CJac t = split_mul(load_cjac(a, n, e + h), k, half_n, j, half, tab);
  CJac q;  // t in both pairs: the second pair's threads take the first's
#pragma unroll
  for (int i = 0; i < fpc::kS; ++i) {
    q.X.v[i] = __shfl_up_sync(fpc::kWarp, t.X.v[i], kPair, 2 * kPair);
    q.Y.v[i] = __shfl_up_sync(fpc::kWarp, t.Y.v[i], kPair, 2 * kPair);
    q.Z.v[i] = __shfl_up_sync(fpc::kWarp, t.Z.v[i], kPair, 2 * kPair);
  }
  const Fq ny = fpc::neg(q.Y);
  q.Y = fpc::sel(half, ny, q.Y);
  const CJac r = cjac_add(load_cjac(a, n, e), q);
  if (live && !fpc::second()) store_cjac(out, n, half ? e + h : e, r);
}

__global__ void __launch_bounds__(kBlock)
    g1_subgroup_mask_kernel(const uint32_t* __restrict__ p,
                            uint8_t* __restrict__ out, int M) {
  bool live;
  const int m = lane_of(kPair, M, live);
  const CJac P = load_cjac(p, M, m);
  const uint32_t x_abs[2] = {kXAbsLo, kXAbsHi};
  CJac xx = P;
#pragma unroll 1
  for (int r = 0; r < 2; ++r) xx = ladder(xx, x_abs);
  // sigma(P) = (BETA X, Y, Z) against -[x^2]P = (X', -Y', Z')
  const Fq X1 = fpc::mul(P.X, fpc::words_of(kBeta));
  const Fq Y2 = fpc::neg(xx.Y);
  const Fq Z11 = fpc::sqr(P.Z);
  const Fq Z22 = fpc::sqr(xx.Z);
  const bool ex = fpc::eq(fpc::mul(X1, Z22), fpc::mul(xx.X, Z11));
  const bool ey = fpc::eq(fpc::mul(fpc::mul(P.Y, xx.Z), Z22), fpc::mul(fpc::mul(Y2, P.Z), Z11));
  const bool inf1 = fpc::is_zero(P.Z);
  const bool inf2 = fpc::is_zero(xx.Z);
  if (live && threadIdx.x % kPair == 0) out[m] = (inf1 || inf2) ? (inf1 == inf2) : (ex && ey);
}

// -- the fold of K Jacobian rows (g1_fold; g1_add is its K = 2) ----------

constexpr int kPoint = 3 * fp::NL;  // words of a Jacobian point in a slot
constexpr int kMaxTeam = kBlock / kPair;  // pairs a column at most: a block

__device__ __forceinline__ Fq load_limbs(const int64_t* __restrict__ base, int B, int b) {
  Fq a;  // this rank's words of an element of the public int64 radix-2^16 limbs
  const int o = fpc::rank() * fpc::kS;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k)
    a.v[k] = (uint32_t)base[(size_t)(2 * (o + k)) * B + b] |
             ((uint32_t)base[(size_t)(2 * (o + k) + 1) * B + b] << 16);
  return a;
}

__device__ __forceinline__ void store_limbs(int64_t* __restrict__ base, int B, int b, const Fq& a) {
  const int o = fpc::rank() * fpc::kS;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    base[(size_t)(2 * (o + k)) * B + b] = a.v[k] & 0xffffu;
    base[(size_t)(2 * (o + k) + 1) * B + b] = a.v[k] >> 16;
  }
}

// g1_fold's rows: [K, 3, 24, B] Jacobian points as public int64 limbs in,
// [3, 24, B] out
struct LimbRows {
  const int64_t* in;
  int64_t* out;
  int B;
  __device__ __forceinline__ CJac load(int k, int b) const {
    const int64_t* p = in + (size_t)k * 3 * 2 * fp::NL * B;
    CJac r;
    r.X = load_limbs(p, B, b);
    r.Y = load_limbs(p + (size_t)2 * fp::NL * B, B, b);
    r.Z = load_limbs(p + (size_t)4 * fp::NL * B, B, b);
    return r;
  }
  __device__ __forceinline__ void store(int b, const CJac& r) const {
    store_limbs(out, B, b, r.X);
    store_limbs(out + (size_t)2 * fp::NL * B, B, b, r.Y);
    store_limbs(out + (size_t)4 * fp::NL * B, B, b, r.Z);
  }
};

// g1_add's rows: p (row 0) and q (row 1), [3, 12, M] u32 words each
struct WordRows {
  const uint32_t* p;
  const uint32_t* q;
  uint32_t* out;
  int B;
  __device__ __forceinline__ CJac load(int k, int b) const { return load_cjac(k ? q : p, B, b); }
  __device__ __forceinline__ void store(int b, const CJac& r) const { store_cjac(out, B, b, r); }
};

__device__ __forceinline__ void put_slot(uint32_t* s, const CJac& P) {
  const int o = fpc::rank() * fpc::kS;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    s[o + k] = P.X.v[k];
    s[fp::NL + o + k] = P.Y.v[k];
    s[2 * fp::NL + o + k] = P.Z.v[k];
  }
}

__device__ __forceinline__ CJac get_slot(const uint32_t* s) {
  const int o = fpc::rank() * fpc::kS;
  CJac P;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    P.X.v[k] = s[o + k];
    P.Y.v[k] = s[fp::NL + o + k];
    P.Z.v[k] = s[2 * fp::NL + o + k];
  }
  return P;
}

// Column b of K >= 2 rows folded as the plain fold does: each level adds
// row j to row half + j for j < half = k / 2 and keeps an odd last row for
// the next level. A column has `team` pairs (a power of two dividing
// kMaxTeam), pair p taking adds p, p + team, ..; each add's sum goes to
// its slot j in shared memory (K / 2 slots a column), the last level's to
// the output. Rows below k - 1 sit in their slots from the second level
// on, and the last row in slot `last`, or in the input while it is still
// row K - 1 passed down. Every pair runs each round (an idle one adds row
// half - 1 again and stores nothing), so whole warps run every add.
template <class Rows>
__global__ void __launch_bounds__(kBlock) g1_fold_kernel(Rows rows, int K, int team) {
  extern __shared__ uint32_t slots[];
  const int pair = threadIdx.x / kPair, p = pair % team;
  const int b = blockIdx.x * (kMaxTeam / team) + pair / team;
  const bool live = b < rows.B;
  const int col = live ? b : rows.B - 1;  // a column past the last computes the last again
  uint32_t* mine = slots + (size_t)(pair / team) * (K / 2) * kPoint;
  int k = K, last = K - 1;
  bool last_in = true;
  for (bool first = true; k > 1; first = false) {
    const int half = k / 2;
    auto row = [&](int r) {
      const int at = r == k - 1 ? last : r;
      return first || (r == k - 1 && last_in) ? rows.load(at, col)
                                              : get_slot(mine + (size_t)at * kPoint);
    };
#pragma unroll 1
    for (int base = 0; base < half; base += team) {
      const bool act = base + p < half;
      const int j = act ? base + p : half - 1;
      const CJac s = cjac_add(row(j), row(half + j));
      if (act && !fpc::second()) {
        if (k == 2) {
          if (live) rows.store(col, s);
        } else {
          put_slot(mine + (size_t)j * kPoint, s);
        }
      }
    }
    if (k % 2 == 0) {
      last = half - 1;
      last_in = false;
    }
    k = half + k % 2;
    __syncthreads();  // this level's sums are in their slots
  }
}

// pairs a column of the fold of K rows: the largest power of two up to
// K / 2, at most a block's
inline int fold_team(int K) {
  int team = 1;
  while (2 * team <= K / 2 && 2 * team <= kMaxTeam) team *= 2;
  return team;
}

// lane m of [12, M] arrays a, b below p -> out [7, 12, M]: the cooperative
// mul(a, b), sqr(a), add(a, b), sub(a, b), then fp::mul(a, b), fp::sqr(a),
// and in plane 6 the cooperative is_zero(a) (limb 0) and eq(a, b) (limb 1)
__global__ void __launch_bounds__(kBlock)
    fp_coop_check_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         uint32_t* __restrict__ out, int M) {
  bool live;
  const int m = lane_of(fpc::kT, M, live);
  const size_t plane = (size_t)fp::NL * M;
  const Fq x = fpc::load(a, M, m);
  const Fq y = fpc::load(b, M, m);
  const Fq r[4] = {fpc::mul(x, y), fpc::sqr(x), fpc::add(x, y), fpc::sub(x, y)};
  const bool x_zero = fpc::is_zero(x), x_eq_y = fpc::eq(x, y);
  Fq flags = fpc::zero();
  flags.v[0] = fpc::rank() == 0 && x_zero;
  flags.v[1] = fpc::rank() == 0 && x_eq_y;
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) fpc::store(out + i * plane, M, m, r[i]);
  fpc::store(out + 6 * plane, M, m, flags);
  if (fpc::rank() == 0) {
    const Fp X = fp::load(a, M, m);
    fp::store(out + 4 * plane, M, m, fp::mul(X, fp::load(b, M, m)));
    fp::store(out + 5 * plane, M, m, fp::sqr(X));
  }
}

// blocks of kBlock threads for M lanes of `per_lane` threads each
inline int coop_blocks(int M, int per_lane) {
  return (int)(((long long)M * per_lane + kBlock - 1) / kBlock);
}

}  // namespace

// Launchers: raw device pointers, the lane count M and a cudaStream_t.
// Each returns cudaGetLastError() after its launch (0 on success).
extern "C" int lwkzg_g1_decompress(const void* x, const void* want_largest,
                                   void* y, void* qr, int M, void* stream) {
  g1_decompress_kernel<<<coop_blocks(M, fpc::kT), kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint8_t*)want_largest, (uint32_t*)y,
      (uint8_t*)qr, M);
  return (int)cudaGetLastError();
}

// split != 0: the split mode (k1, k2 in words 0-3 and 4-7; nbits unused)
extern "C" int lwkzg_g1_scalar_mul(const void* p, const void* k, int k_stride,
                                   void* out, int M, int nbits, int split,
                                   void* stream) {
  if (split) {
    g1_scalar_mul_split_kernel<<<coop_blocks(M, 2 * kPair), kBlock, 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)k, k_stride, (uint32_t*)out, M);
  } else {
    g1_scalar_mul_kernel<<<coop_blocks(M, kPair), kBlock, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)k, k_stride, (uint32_t*)out, M,
        nbits);
  }
  return (int)cudaGetLastError();
}

// a [3, 12, n] in, out [3, 12, n], k [8, n/2]; length = 2h, 2 <= length <= n
extern "C" int lwkzg_g1_fft_stage(const void* a, const void* k, void* out, int n,
                                  int length, void* stream) {
  g1_fft_stage_kernel<<<coop_blocks(n / 2, 2 * kPair), kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)k, (uint32_t*)out, n, length / 2);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_g1_subgroup_mask(const void* p, void* out, int M,
                                      void* stream) {
  g1_subgroup_mask_kernel<<<coop_blocks(M, kPair), kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint8_t*)out, M);
  return (int)cudaGetLastError();
}

// p, q, out [3, 12, M]: the fold of the two rows p and q
extern "C" int lwkzg_g1_add(const void* p, const void* q, void* out, int M, void* stream) {
  g1_fold_kernel<<<coop_blocks(M, kPair), kBlock, 0, (cudaStream_t)stream>>>(
      WordRows{(const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, M}, 2, 1);
  return (int)cudaGetLastError();
}

// in [K, 3, 24, B] int64 limbs, K >= 2, out [3, 24, B]; a block holds
// K / 2 slots of 144 bytes for each of its columns, 18 KB at the
// wrapper's largest K, 256
extern "C" int lwkzg_g1_fold(const void* in, void* out, int K, int B, void* stream) {
  const int team = fold_team(K), cols = kMaxTeam / team;
  const size_t smem = K > 2 ? (size_t)cols * (K / 2) * kPoint * sizeof(uint32_t) : 0;
  g1_fold_kernel<<<(B + cols - 1) / cols, kBlock, smem, (cudaStream_t)stream>>>(
      LimbRows{(const int64_t*)in, (int64_t*)out, B}, K, team);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fp_coop_check(const void* a, const void* b, void* out,
                                   int M, void* stream) {
  fp_coop_check_kernel<<<coop_blocks(M, fpc::kT), kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, M);
  return (int)cudaGetLastError();
}
