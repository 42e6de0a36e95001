// BLS12-381 G1 point kernels for Hopper (sm_90a): g1_madd, g1_add, g1_dbl.
//
// They replace the TPU kernels of lambdaworks_kzg_tpu/ops/pallas_g1_v2.py:
//   g1_madd <- madd (_madd_kernel): bucket += affine point, every lock-step
//              round of the fixed-base MSM
//   g1_add  <- add  (_add_kernel):  fold reduce and lane-group tree sums
//   g1_dbl  <- dbl  (_dbl_kernel):  fixed-base table build, Horner step
// and, through them, the v1-layout kernels of ops/pallas_g1.py, whose
// function is the same bit for bit.
//
// Layout: limbs-first u32 arrays, [3, 12, M] Jacobian (X, Y, Z) and
// [2, 12, M] affine (x, y), Montgomery form, R = 2^384; coordinate c,
// limb k of lane m sits at (c * 12 + k) * M + m, so a warp's loads of one
// limb are contiguous. Infinity is Z == 0.
//
// Design (first, simple): one thread per lane, everything in registers,
// the exceptional lanes of the TPU kernels' jnp.where selects taken as
// per-lane branches. The formulas run in the order of ops/formulas.py,
// and every field result is fully reduced, so the outputs equal the plain
// PyTorch versions (ops/g1_ops.py) limb for limb, Z included.
//
// What bounds it: each lane moves 385 bytes (madd: 144 in + 96 in + 1
// live + 144 out), 432 (add) or 288 (dbl), and does 11 (madd), 16 (add)
// or 8 (dbl) Montgomery products of 588 32-bit multiply-adds each (a
// 32x32->64 product is two IMADs). At 11 x 588 = 6,468 IMADs against 385
// bytes the kernels are bound by integer multiply throughput, not by
// memory; at the MSM's 2,048 lanes they also fill only 16 blocks of the
// card's 132 SMs, so one thread's latency sets a launch's time at the
// path's shapes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp.cuh"

namespace {

using fp::Fp;

constexpr int kThreads = 128;

struct Jac {
  Fp X, Y, Z;
};

__device__ __forceinline__ Jac load_jac(const uint32_t* __restrict__ p, int M,
                                        int m) {
  Jac r;
  r.X = fp::load(p, M, m);
  r.Y = fp::load(p + (size_t)fp::NL * M, M, m);
  r.Z = fp::load(p + (size_t)2 * fp::NL * M, M, m);
  return r;
}

__device__ __forceinline__ void store_jac(uint32_t* __restrict__ out, int M,
                                          int m, const Jac& r) {
  fp::store(out, M, m, r.X);
  fp::store(out + (size_t)fp::NL * M, M, m, r.Y);
  fp::store(out + (size_t)2 * fp::NL * M, M, m, r.Z);
}

__device__ __forceinline__ Jac jac_zero() {
  Jac r;
  r.X = fp::zero();
  r.Y = fp::zero();
  r.Z = fp::zero();
  return r;
}

// dbl-2009-l (a = 0); Z = 0 stays Z = 0
__device__ __forceinline__ Jac jac_dbl(const Jac& p) {
  using namespace fp;
  const Fp XX = sqr(p.X);
  const Fp YY = sqr(p.Y);
  const Fp YYYY = sqr(YY);
  const Fp ZZ = sqr(p.Z);
  Fp S = sub(sub(sqr(add(p.X, YY)), XX), YYYY);
  S = add(S, S);
  const Fp M = add(add(XX, XX), XX);
  const Fp T = sub(sqr(M), add(S, S));
  const Fp Y8 = dbl(dbl(dbl(YYYY)));
  Jac r;
  r.X = T;
  r.Y = sub(mul(M, sub(S, T)), Y8);
  r.Z = sub(sub(sqr(add(p.Y, p.Z)), YY), ZZ);
  return r;
}

// add-2007-bl with the same-x fixups; p or q at infinity handled by caller
__device__ __forceinline__ Jac jac_add_finite(const Jac& p, const Jac& q) {
  using namespace fp;
  const Fp Z1Z1 = sqr(p.Z);
  const Fp Z2Z2 = sqr(q.Z);
  const Fp U1 = mul(p.X, Z2Z2);
  const Fp U2 = mul(q.X, Z1Z1);
  const Fp S1 = mul(mul(p.Y, q.Z), Z2Z2);
  const Fp S2 = mul(mul(q.Y, p.Z), Z1Z1);
  const Fp H = sub(U2, U1);
  const Fp Rr = sub(S2, S1);
  if (is_zero(H)) {
    return is_zero(Rr) ? jac_dbl(p) : jac_zero();
  }
  const Fp HH = sqr(H);
  const Fp I = dbl(dbl(HH));
  const Fp J = mul(H, I);
  const Fp r2 = add(Rr, Rr);
  const Fp V = mul(U1, I);
  Jac r;
  r.X = sub(sub(sqr(r2), J), add(V, V));
  const Fp S1J = mul(S1, J);
  r.Y = sub(mul(r2, sub(V, r.X)), add(S1J, S1J));
  r.Z = mul(sub(sub(sqr(add(p.Z, q.Z)), Z1Z1), Z2Z2), H);
  return r;
}

// madd-2007-bl with the same-x fixups; p at infinity handled by caller
__device__ __forceinline__ Jac jac_madd_finite(const Jac& p, const Fp& X2,
                                               const Fp& Y2) {
  using namespace fp;
  const Fp Z1Z1 = sqr(p.Z);
  const Fp U2 = mul(X2, Z1Z1);
  const Fp S2 = mul(mul(Y2, p.Z), Z1Z1);
  const Fp H = sub(U2, p.X);
  const Fp Rr = sub(S2, p.Y);
  if (is_zero(H)) {
    return is_zero(Rr) ? jac_dbl(p) : jac_zero();
  }
  const Fp HH = sqr(H);
  const Fp I = dbl(dbl(HH));
  const Fp J = mul(H, I);
  const Fp r2 = add(Rr, Rr);
  const Fp V = mul(p.X, I);
  Jac r;
  r.X = sub(sub(sqr(r2), J), add(V, V));
  const Fp Y1J = mul(p.Y, J);
  r.Y = sub(mul(r2, sub(V, r.X)), add(Y1J, Y1J));
  r.Z = sub(sub(sqr(add(p.Z, H)), Z1Z1), HH);
  return r;
}

__global__ void __launch_bounds__(kThreads)
    g1_madd_kernel(const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ q,
                   const uint8_t* __restrict__ live,
                   uint32_t* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Jac a = load_jac(p, M, m);
  Jac r;
  if (!live[m]) {
    r = a;  // dead lane: the bucket passes through
  } else {
    const Fp X2 = fp::load(q, M, m);
    const Fp Y2 = fp::load(q + (size_t)fp::NL * M, M, m);
    if (fp::is_zero(a.Z)) {  // empty bucket: lift q with Z = 1
      r.X = X2;
      r.Y = Y2;
      r.Z = fp::one();
    } else {
      r = jac_madd_finite(a, X2, Y2);
    }
  }
  store_jac(out, M, m, r);
}

__global__ void __launch_bounds__(kThreads)
    g1_add_kernel(const uint32_t* __restrict__ p,
                  const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                  int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Jac a = load_jac(p, M, m);
  const Jac b = load_jac(q, M, m);
  Jac r;
  if (fp::is_zero(b.Z)) {
    r = a;
  } else if (fp::is_zero(a.Z)) {
    r = b;
  } else {
    r = jac_add_finite(a, b);
  }
  store_jac(out, M, m, r);
}

__global__ void __launch_bounds__(kThreads)
    g1_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                  int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  store_jac(out, M, m, jac_dbl(load_jac(p, M, m)));
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
