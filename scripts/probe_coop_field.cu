// Latency probe of the cooperative field (lambdaworks_kzg_tpu_torch/csrc/
// fp_coop.cuh) against fp.cuh: each kernel runs a dependent chain of n
// operations per element, so n / time is one chain's rate. Built and run
// by scripts/probe_coop_field.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../lambdaworks_kzg_tpu_torch/csrc/fp_coop.cuh"

namespace {

constexpr int kBlock = 64;

__global__ void __launch_bounds__(kBlock) fp_mul_chain(const uint32_t* a, uint32_t* out, int M, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  fp::Fp x = fp::load(a, M, m);
  const fp::Fp y = x;
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fp::mul(x, y);
  fp::store(out, M, m, x);
}

__global__ void __launch_bounds__(kBlock) fp_add_chain(const uint32_t* a, uint32_t* out, int M, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  fp::Fp x = fp::load(a, M, m);
  const fp::Fp y = x;
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fp::add(x, y);
  fp::store(out, M, m, x);
}

__global__ void __launch_bounds__(kBlock) coop_mul_chain(const uint32_t* a, uint32_t* out, int M, int n) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / fpc::kT;
  if (m >= M) return;
  fpc::Fq x = fpc::load(a, M, m);
  const fpc::Fq y = x;
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fpc::mul(x, y);
  fpc::store(out, M, m, x);
}

__global__ void __launch_bounds__(kBlock) coop_add_chain(const uint32_t* a, uint32_t* out, int M, int n) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / fpc::kT;
  if (m >= M) return;
  fpc::Fq x = fpc::load(a, M, m);
  const fpc::Fq y = x;
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fpc::add(x, y);
  fpc::store(out, M, m, x);
}

// one shuffle per step, each depending on the last
__global__ void __launch_bounds__(kBlock) coop_shfl_chain(const uint32_t* a, uint32_t* out, int M, int n) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / fpc::kT;
  if (m >= M) return;
  uint32_t v = a[m];
#pragma unroll 1
  for (int i = 0; i < n; ++i) v = fpc::from_rank(v, i & (fpc::kT - 1)) + 1u;
  out[(size_t)fpc::rank() * M + m] = v;
}

// one carry resolution (two ballots) per step, each depending on the last
__global__ void __launch_bounds__(kBlock) coop_carry_chain(const uint32_t* a, uint32_t* out, int M, int n) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / fpc::kT;
  if (m >= M) return;
  uint32_t v = a[m] + fpc::rank();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    uint32_t top;
    v += fpc::carry_in((v & 3u) == 1u, (v & 3u) == 2u, top) + top + 1u;
  }
  out[(size_t)fpc::rank() * M + m] = v;
}

}  // namespace

// which: 0 fp::mul, 1 fp::add, 2 fpc::mul, 3 fpc::add, 4 shuffle, 5 carry
extern "C" int probe_chain(int which, const void* a, void* out, int M, int n, void* stream) {
  const int per = which >= 2 ? fpc::kT : 1;
  const int blocks = (int)(((long long)M * per + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* ai = (const uint32_t*)a;
  uint32_t* o = (uint32_t*)out;
  switch (which) {
    case 0: fp_mul_chain<<<blocks, kBlock, 0, s>>>(ai, o, M, n); break;
    case 1: fp_add_chain<<<blocks, kBlock, 0, s>>>(ai, o, M, n); break;
    case 2: coop_mul_chain<<<blocks, kBlock, 0, s>>>(ai, o, M, n); break;
    case 3: coop_add_chain<<<blocks, kBlock, 0, s>>>(ai, o, M, n); break;
    case 4: coop_shfl_chain<<<blocks, kBlock, 0, s>>>(ai, o, M, n); break;
    default: coop_carry_chain<<<blocks, kBlock, 0, s>>>(ai, o, M, n); break;
  }
  return (int)cudaGetLastError();
}
