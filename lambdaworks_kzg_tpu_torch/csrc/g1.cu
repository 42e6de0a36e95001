// BLS12-381 G1 point kernels for Hopper (sm_90a): g1_madd, g1_add, g1_dbl.
//
// They replace the TPU kernels of lambdaworks_kzg_tpu/ops/pallas_g1_v2.py:
//   g1_madd <- madd (_madd_kernel): bucket += affine point
//   g1_add  <- add  (_add_kernel):  complete Jacobian add
//   g1_dbl  <- dbl  (_dbl_kernel):  doubling; the fixed-base table build
// and, through them, the v1-layout kernels of ops/pallas_g1.py, whose
// function is the same bit for bit. On the commit path the lock-step madd
// rounds and the fold reduce run fused in msm.cu (g1_bucket_accumulate,
// g1_bucket_reduce) and the table build's doublings in table.cu
// (g1_fixedbase_table), on the same group law (g1.cuh); these three are
// the per-op forms of those steps. fp_sqr_check holds fp::sqr against
// fp::mul(a, a) on the card.
//
// Layout: limbs-first u32 arrays, [3, 12, M] Jacobian (X, Y, Z) and
// [2, 12, M] affine (x, y), Montgomery form, R = 2^384; coordinate c,
// limb k of lane m sits at (c * 12 + k) * M + m, so a warp's loads of one
// limb are contiguous. Infinity is Z == 0.
//
// Design: one thread per lane, everything in registers,
// the exceptional lanes of the TPU kernels' jnp.where selects taken as
// per-lane branches. The formulas run in the order of ops/formulas.py,
// and every field result is fully reduced, so the outputs equal the plain
// PyTorch versions (ops/g1_ops.py) limb for limb, Z included.
//
// What bounds it: each lane moves 385 bytes (madd: 144 in + 96 in + 1
// live + 144 out), 432 (add) or 288 (dbl), and needs 7 Montgomery products
// and 4 squarings (madd), 11 and 5 (add) or 2 and 5 (dbl, with Z3 = 2 Y Z;
// jac_dbl's (Y + Z)^2 - YY - ZZ takes 1 and 7, 324 IMADs more). A product
// is 588 32-bit multiply-adds (a 32x32->64 product is two IMADs), a
// squaring that shares its cross products (fp::sqr) 456. At 5,940
// IMADs against 385 bytes the kernels are bound by integer multiply
// throughput, not by memory; at the MSM's 2,048 lanes they also fill only 16 blocks of the
// card's 132 SMs, so one thread's latency sets a launch's time at the
// path's shapes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"

namespace {

using fp::Fp;
using g1::Jac;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    g1_madd_kernel(const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ q,
                   const uint8_t* __restrict__ live,
                   uint32_t* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Jac a = g1::load_jac(p, M, m);
  Jac r;
  if (!live[m]) {
    r = a;  // dead lane: the bucket passes through
  } else {
    const Fp X2 = fp::load(q, M, m);
    const Fp Y2 = fp::load(q + (size_t)fp::NL * M, M, m);
    r = g1::jac_madd(a, X2, Y2);
  }
  g1::store_jac(out, M, m, r);
}

__global__ void __launch_bounds__(kThreads)
    g1_add_kernel(const uint32_t* __restrict__ p,
                  const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                  int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Jac a = g1::load_jac(p, M, m);
  const Jac b = g1::load_jac(q, M, m);
  g1::store_jac(out, M, m, g1::jac_add(a, b));
}

__global__ void __launch_bounds__(kThreads)
    g1_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                  int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  g1::store_jac(out, M, m, g1::jac_dbl(g1::load_jac(p, M, m)));
}

// lane m of a [12, M] array of values below p: sqr(a) and mul(a, a)
__global__ void __launch_bounds__(kThreads)
    fp_sqr_check_kernel(const uint32_t* __restrict__ a,
                        uint32_t* __restrict__ sq, uint32_t* __restrict__ mm,
                        int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Fp x = fp::load(a, M, m);
  fp::store(sq, M, m, fp::sqr(x));
  fp::store(mm, M, m, fp::mul(x, x));
}

inline int blocks_for(int M) { return (M + kThreads - 1) / kThreads; }

}  // namespace

// Launchers: raw device pointers, the lane count M and a cudaStream_t.
// Each returns cudaGetLastError() after its launch (0 on success).
extern "C" int lwkzg_g1_madd(const void* p, const void* q, const void* live,
                             void* out, int M, void* stream) {
  g1_madd_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)live,
      (uint32_t*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_g1_add(const void* p, const void* q, void* out, int M,
                            void* stream) {
  g1_add_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_g1_dbl(const void* p, void* out, int M, void* stream) {
  g1_dbl_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fp_sqr_check(const void* a, void* sq, void* mm, int M,
                                  void* stream) {
  fp_sqr_check_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)sq, (uint32_t*)mm, M);
  return (int)cudaGetLastError();
}
