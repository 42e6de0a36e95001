// The fixed-base table build for Hopper (sm_90a): g1_fixedbase_table.
//
// It replaces, on the commit path, the TPU kernel dbl of
// lambdaworks_kzg_tpu/ops/pallas_g1_v2.py (_dbl_kernel) as
// lambdaworks_kzg_tpu/ops/msm.py::build_fixedbase_tables (:714-750) runs
// it: a scan of W c-fold doublings over every source point, then an affine
// step that inverts all W N Z coordinates (FP.inv, one Fermat power per
// table entry). Its plain version is ops/g1_ops.py::fixedbase_table.
//
// Entry (w, i) is the affine [2^(c w)] P_i for w < W = ceil(256 / c),
// written as row w N + i of [W N, 2, 12] u32 Montgomery words (x, then y):
// the layout g1_bucket_accumulate reads, so the table needs no relayout
// and never leaves the card. A point at infinity (an invalid source lane)
// gives (0, 0) in every window, as FP.inv(0) = 0 gives it in the reference.
//
// Design: one thread per source lane, in three passes over its windows.
//   1. Forward: the thread lifts its point and keeps window w's Jacobian
//      in registers; it writes X_w, Y_w into row w N + i (overwritten in
//      pass 3), Z_w and the prefix product Z_0 .. Z_{w-1} into a global
//      scratch [W, 2, 12, N] (limbs-first, so a warp's stores of one limb
//      are contiguous), multiplies the prefix by Z_w (a Z = 0 counts as
//      one) and doubles c times to reach window w + 1.
//   2. One Fermat inversion of the prefix of all W windows (fp::inv).
//   3. Backward (Montgomery's batch trick along the thread's own
//      windows): Z_w^-1 = inv * prefix_{w-1}, then inv *= Z_w, and the row
//      becomes x = X Z^-2, y = Y Z^-3, or (0, 0) where Z_w = 0.
// The reference inverts per entry because "prefix products are
// sequential over the batch - the wrong axis on TPU" (field_ops.py:111);
// here a thread's windows are that sequential axis while the lanes stay
// parallel, so a lane needs one inversion instead of W.
//
// What bounds it: per valid lane (W - 1) c doublings (248 at c = 8; at
// least 2 products and 5 squarings each, where jac_dbl runs 1 and 7), one
// inversion (a 5-bit sliding window needs 82 products and 378 squarings;
// fp::inv runs 228 and 380) and about 7 products per window, ~1.20e6
// 32-bit multiply-adds per lane at c = 8 beside 97 bytes in and W * 96
// bytes out: the operations bound it (~0.29 ms of IMADs at N = 4096,
// c = 8 on an H100, against ~4 us of bytes). But 4096 lanes are 128
// warps, at most one per SM sub-partition, and each thread's work is one
// dependent chain of ~2,800 Montgomery products, so the launch takes one
// chain's latency, far above its bound.
// Blocks are one warp each, so a mainnet build spreads over 128 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"

namespace {

using fp::Fp;
using g1::Jac;

constexpr int kTableThreads = 32;
constexpr int kRowVecs = 6;  // a row: x, y = 24 words = 6 x 16 bytes

__device__ __forceinline__ void st_row(uint4* r, const Fp& x, const Fp& y) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[k] = make_uint4(x.v[4 * k], x.v[4 * k + 1], x.v[4 * k + 2], x.v[4 * k + 3]);
    r[3 + k] = make_uint4(y.v[4 * k], y.v[4 * k + 1], y.v[4 * k + 2], y.v[4 * k + 3]);
  }
}

__device__ __forceinline__ void ld_row(const uint4* r, Fp& x, Fp& y) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 a = r[k], b = r[3 + k];
    x.v[4 * k] = a.x, x.v[4 * k + 1] = a.y, x.v[4 * k + 2] = a.z, x.v[4 * k + 3] = a.w;
    y.v[4 * k] = b.x, y.v[4 * k + 1] = b.y, y.v[4 * k + 2] = b.z, y.v[4 * k + 3] = b.w;
  }
}

__global__ void __launch_bounds__(kTableThreads)
    g1_fixedbase_table_kernel(const uint32_t* __restrict__ points,
                              const uint8_t* __restrict__ valid,
                              uint4* __restrict__ table,
                              uint32_t* __restrict__ scratch, int N, int c,
                              int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t row_step = (size_t)N * kRowVecs;  // from window w to w + 1
  uint4* row = table + (size_t)i * kRowVecs;
  // scratch slot (w, s): s = 0 holds Z_w, s = 1 the prefix Z_0 .. Z_{w-1}
  auto slot = [&](int w, int s) {
    return scratch + (size_t)(2 * w + s) * fp::NL * N;
  };

  if (!valid[i]) {
    const Fp z = fp::zero();
    for (int w = 0; w < W; ++w) st_row(row + w * row_step, z, z);
    return;
  }

  Jac p;
  p.X = fp::load(points, N, i);
  p.Y = fp::load(points + (size_t)fp::NL * N, N, i);
  p.Z = fp::one();
  Fp prefix = fp::one();
  for (int w = 0; w < W; ++w) {
    st_row(row + w * row_step, p.X, p.Y);
    fp::store(slot(w, 0), N, i, p.Z);
    if (w > 0) fp::store(slot(w, 1), N, i, prefix);
    if (!fp::is_zero(p.Z)) prefix = w > 0 ? fp::mul(prefix, p.Z) : p.Z;
    if (w + 1 < W) {
      for (int k = 0; k < c; ++k) p = g1::jac_dbl(p);
    }
  }

  Fp rest = fp::inv(prefix);  // 1 / (Z_0 .. Z_w), from w = W - 1 down
  for (int w = W - 1; w >= 0; --w) {
    const Fp Z = fp::load(slot(w, 0), N, i);
    Fp zinv = rest;
    if (w > 0) {
      zinv = fp::mul(rest, fp::load(slot(w, 1), N, i));
      if (!fp::is_zero(Z)) rest = fp::mul(rest, Z);
    }
    uint4* r = row + w * row_step;
    if (fp::is_zero(Z)) {
      st_row(r, fp::zero(), fp::zero());
      continue;
    }
    Fp X, Y;
    ld_row(r, X, Y);
    const Fp zinv2 = fp::sqr(zinv);
    st_row(r, fp::mul(X, zinv2), fp::mul(Y, fp::mul(zinv2, zinv)));
  }
}

}  // namespace

// Launcher: raw device pointers (points [2, 12, N] u32, valid bool[N],
// table [W N, 2, 12], scratch [W, 2, 12, N]), sizes and a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lwkzg_g1_fixedbase_table(const void* points, const void* valid,
                                        void* table, void* scratch, int N,
                                        int c, int W, void* stream) {
  g1_fixedbase_table_kernel<<<(N + kTableThreads - 1) / kTableThreads,
                              kTableThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)points, (const uint8_t*)valid, (uint4*)table,
      (uint32_t*)scratch, N, c, W);
  return (int)cudaGetLastError();
}
