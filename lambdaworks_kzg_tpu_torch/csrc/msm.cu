// The fixed-base MSM's two hot stages for Hopper (sm_90a), each one launch
// per batch of blobs:
//
//   g1_bucket_accumulate <- the lock-step accumulation while_loop of
//       lambdaworks_kzg_tpu/ops/msm.py::msm_fixedbase_device (:787-852),
//       whose body gathers table rows and runs the Pallas madd
//       (ops/pallas_g1_v2.py::madd, _madd_kernel) once per round.
//   g1_bucket_reduce <- the fold reduce and group tree of the same function,
//       ops/msm.py::_bucket_reduce_fold (:598) and _tree_sum_lanes (:447),
//       whose adds and doublings are the Pallas add and dbl.
//
// Both run on the group law of g1.cuh and the field of fp.cuh, in the order
// of the plain versions (ops/g1_ops.py bucket_accumulate / bucket_reduce),
// so the results equal them limb for limb, Z included.
//
// What bounds them on the card, and what the design does about it:
//
// g1_bucket_accumulate. Thread (b, g, j) owns the Jacobian bucket j of lane
// group g for blob b: it walks its members bstart[j] + g + t * G < bend[j]
// of the digit-sorted order, keeps the bucket in registers across all
// rounds and writes it once. Per live member it reads a 4-byte order entry
// and a 96-byte table row; each member but the first of a bucket needs 7
// Montgomery products and 4 squarings (5,940 IMADs), so the operations
// bound it (a random blob's ~128,500 madds: ~46 us of IMADs against ~4 us
// of bytes on an H100). At one blob the grid is only 8 x 256 threads
// (64 warps on 132 SMs), so the time is one thread's dependent chain of
// madds over its longest bucket; a batch of B blobs puts B times as many
// warps on the card at the same chain length. The row of the next member
// is fetched with cp.async into a per-thread shared-memory double buffer
// while the current madd runs, and the order entry one member further
// ahead, so the gather's latency hides behind the arithmetic. There is no
// host read of the longest bucket and no gathered copy of the rows.
//
// g1_bucket_reduce. Block (b, g) holds its group's 2^c buckets and the
// partial tree sums (3 * 2^(c-1) points of 144 bytes) in shared memory when
// they fit (c <= 10), else in a global scratch that stays in L2 (c = 12),
// under the same schedule. Step s (s = 0 .. c-2) runs, with a
// __syncthreads() after it, fold round s (h = 2^(c-1-s) adds a_i + a_{i+h})
// together with the first tree level of that round's high half and the
// next level of every earlier round's tree: all read what step s-1 wrote.
// Thread 0 then runs the Horner combine sum_r 2^(c-r) E_r, and the last
// block of a blob to finish (an atomic count after __threadfence) adds the
// G group sums in the pairwise order of tree_sum_lanes. The work is ~4,070
// adds and 56 doublings per blob at c = 8 (~2.1 us of IMADs), but the
// critical path is c - 1 steps + (c - 1) x (dbl + add) + log2 G adds, each
// one thread's latency: it stays chain-bound far above its bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"

namespace {

using fp::Fp;
using g1::Jac;

constexpr int kAccThreads = 128;
constexpr int kRowVecs = 6;     // a table row: x, y = 24 words = 6 x 16 bytes
constexpr int kPointVecs = 9;   // a Jacobian point: X, Y, Z = 36 words
constexpr int kMaxGroups = 32;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void words_to_fp(Fp& f, int k0, const uint4& v) {
  f.v[k0] = v.x;
  f.v[k0 + 1] = v.y;
  f.v[k0 + 2] = v.z;
  f.v[k0 + 3] = v.w;
}

__global__ void __launch_bounds__(kAccThreads)
    g1_bucket_accumulate_kernel(const uint4* __restrict__ table,
                                const int32_t* __restrict__ order,
                                const int32_t* __restrict__ bstart,
                                uint32_t* __restrict__ out, int n_members,
                                int c, int groups, int M) {
  __shared__ uint4 rows[2][kRowVecs][kAccThreads];
  const int tid = threadIdx.x;
  const int m = blockIdx.x * kAccThreads + tid;
  if (m >= M) return;
  const int nb = 1 << c;
  const int per_blob = groups << c;
  const int b = m / per_blob;
  const int g = (m - b * per_blob) >> c;
  const int j = m & (nb - 1);
  Jac acc = g1::jac_zero();
  if (j != 0) {  // bucket 0 (weight 0; invalid members) stays empty
    const int32_t* ord = order + (size_t)b * n_members;
    const int32_t* bs = bstart + (size_t)b * nb;
    const int first = bs[j] + g;
    const int end = j + 1 < nb ? bs[j + 1] : n_members;
    const int count = first < end ? (end - first + groups - 1) / groups : 0;
    auto fetch = [&](int member, int stage) {
      const uint4* src = table + (size_t)member * kRowVecs;
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) cp_async16(&rows[stage][k][tid], src + k);
    };
    if (count > 0) {
      fetch(ord[first], 0);
      cp_async_commit();
      int next = count > 1 ? ord[first + groups] : 0;
      for (int t = 0; t < count; ++t) {
        if (t + 1 < count) {
          fetch(next, (t + 1) & 1);
          if (t + 2 < count) next = ord[first + (t + 2) * groups];
        }
        cp_async_commit();  // one group per round, empty on the last
        cp_async_wait_prev();
        Fp X, Y;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          words_to_fp(X, 4 * k, rows[t & 1][k][tid]);
          words_to_fp(Y, 4 * k, rows[t & 1][3 + k][tid]);
        }
        acc = g1::jac_madd(acc, X, Y);
      }
    }
  }
  g1::store_jac(out, M, m, acc);
}

// a point as 9 x 16 bytes: X, Y, Z words in order
__device__ __forceinline__ Jac ld_pt(const uint4* p) {
  Jac r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    words_to_fp(r.X, 4 * k, p[k]);
    words_to_fp(r.Y, 4 * k, p[3 + k]);
    words_to_fp(r.Z, 4 * k, p[6 + k]);
  }
  return r;
}

// the same from global memory written by another block: past L1
__device__ __forceinline__ Jac ld_pt_cg(const uint4* p) {
  Jac r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    words_to_fp(r.X, 4 * k, __ldcg(p + k));
    words_to_fp(r.Y, 4 * k, __ldcg(p + 3 + k));
    words_to_fp(r.Z, 4 * k, __ldcg(p + 6 + k));
  }
  return r;
}

__device__ __forceinline__ void st_pt(uint4* p, const Jac& a) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = make_uint4(a.X.v[4 * k], a.X.v[4 * k + 1], a.X.v[4 * k + 2],
                      a.X.v[4 * k + 3]);
    p[3 + k] = make_uint4(a.Y.v[4 * k], a.Y.v[4 * k + 1], a.Y.v[4 * k + 2],
                          a.Y.v[4 * k + 3]);
    p[6 + k] = make_uint4(a.Z.v[4 * k], a.Z.v[4 * k + 1], a.Z.v[4 * k + 2],
                          a.Z.v[4 * k + 3]);
  }
}

// Block (b, g). `scratch` is null for the shared-memory route; otherwise
// it holds 3 * 2^(c-1) points per block. Points a[0 .. 2^c) are the
// buckets (a[0] cleared), tree region T_r of round r (h_r = 2^(c-1-r)
// high-half entries, h_r / 2 tree entries) starts at T + 2^(c-1) - h_r.
__global__ void __launch_bounds__(kReduceThreads)
    g1_bucket_reduce_kernel(const uint32_t* __restrict__ buckets,
                            uint4* __restrict__ scratch,
                            uint4* __restrict__ group_sums,
                            int* __restrict__ done, uint32_t* __restrict__ out,
                            int c, int groups, int B) {
  extern __shared__ uint4 smem[];
  __shared__ uint4 gsum[kMaxGroups * kPointVecs];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int bg = blockIdx.x;
  const int b = bg / groups;
  const int nb = 1 << c;
  const int M = B * groups * nb;
  uint4* a = scratch ? scratch + (size_t)bg * (nb + nb / 2) * kPointVecs : smem;
  uint4* T = a + (size_t)nb * kPointVecs;

  for (int i = tid; i < nb; i += nthr) {
    const Jac p = i == 0 ? g1::jac_zero() : g1::load_jac(buckets, M, bg * nb + i);
    st_pt(a + (size_t)i * kPointVecs, p);
  }
  __syncthreads();

  for (int s = 0; s + 2 <= c; ++s) {
    const int h = nb >> (s + 1);  // fold round s: a_i += a_{i+h}, i < h
    const int q = h >> 1;         // every tree level at this step is q wide
    const int items = h + (s + 1) * q;
    for (int it = tid; it < items; it += nthr) {
      const uint4* x;
      const uint4* y;
      uint4* dst;
      if (it < h) {
        dst = a + (size_t)it * kPointVecs;
        x = dst;
        y = a + (size_t)(it + h) * kPointVecs;
      } else {
        const int k = it - h;
        const int r = k / q;  // round r's tree, at level s - r + 1
        const int i = k - r * q;
        uint4* Tr = T + (size_t)((nb >> 1) - (nb >> (r + 1))) * kPointVecs;
        dst = Tr + (size_t)i * kPointVecs;
        if (r == s) {  // level 1 reads round s's high half, as the fold does
          x = a + (size_t)(h + i) * kPointVecs;
          y = a + (size_t)(h + i + q) * kPointVecs;
        } else {
          x = dst;
          y = Tr + (size_t)(i + q) * kPointVecs;
        }
      }
      st_pt(dst, g1::jac_add(ld_pt(x), ld_pt(y)));
    }
    __syncthreads();
  }

  if (tid == 0) {
    // E_r: round r's high-half total; h_r = 1 (r = c - 1) is a[1] itself
    auto total = [&](int r) {
      const int hr = nb >> (r + 1);
      return ld_pt(hr >= 2 ? T + (size_t)((nb >> 1) - hr) * kPointVecs
                           : a + kPointVecs);
    };
    Jac acc = total(0);
    for (int r = 1; r < c; ++r) acc = g1::jac_add(g1::jac_dbl(acc), total(r));
    st_pt(group_sums + (size_t)bg * kPointVecs, acc);
    __threadfence();
    last = atomicAdd(done + b, 1) == groups - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block of blob b to finish: its G group sums, pairwise
  __threadfence();
  for (int i = tid; i < groups; i += nthr)
    st_pt(gsum + i * kPointVecs,
          ld_pt_cg(group_sums + (size_t)(b * groups + i) * kPointVecs));
  __syncthreads();
  for (int half = groups >> 1; half >= 1; half >>= 1) {
    if (tid < half)
      st_pt(gsum + tid * kPointVecs,
            g1::jac_add(ld_pt(gsum + tid * kPointVecs),
                        ld_pt(gsum + (tid + half) * kPointVecs)));
    __syncthreads();
  }
  if (tid == 0) g1::store_jac(out, B, b, ld_pt(gsum));
}

}  // namespace

// Launchers: raw device pointers, sizes and a cudaStream_t. Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int lwkzg_g1_bucket_accumulate(const void* table, const void* order,
                                          const void* bstart, void* out,
                                          int n_members, int c, int groups,
                                          int B, void* stream) {
  const int M = B * (groups << c);
  g1_bucket_accumulate_kernel<<<(M + kAccThreads - 1) / kAccThreads,
                                kAccThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int32_t*)order, (const int32_t*)bstart,
      (uint32_t*)out, n_members, c, groups, M);
  return (int)cudaGetLastError();
}

// scratch: null for the shared-memory route (the caller checked the fit)
extern "C" int lwkzg_g1_bucket_reduce(const void* buckets, void* scratch,
                                      void* group_sums, void* done, void* out,
                                      int c, int groups, int B, void* stream) {
  const int nb = 1 << c;
  const int smem = scratch ? 0 : (nb + nb / 2) * kPointVecs * 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        g1_bucket_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one thread per item of the widest step (3 * 2^c / 4), in whole warps
  int threads = ((3 * nb / 4 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kReduceThreads ? kReduceThreads : threads);
  g1_bucket_reduce_kernel<<<B * groups, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)buckets, (uint4*)scratch, (uint4*)group_sums,
      (int*)done, (uint32_t*)out, c, groups, B);
  return (int)cudaGetLastError();
}
