// The MSMs' hot stages for Hopper (sm_90a), each one launch per batch of
// blobs:
//
//   g1_bucket_accumulate <- the lock-step accumulation while_loop of
//       lambdaworks_kzg_tpu/ops/msm.py::msm_fixedbase_device (:787-852),
//       whose body gathers table rows and runs the Pallas madd
//       (ops/pallas_g1_v2.py::madd, _madd_kernel) once per round.
//   g1_bucket_reduce <- the fold reduce and group tree of the same function,
//       ops/msm.py::_bucket_reduce_fold (:598) and _tree_sum_lanes (:447),
//       whose adds and doublings are the Pallas add and dbl.
//   g1_window_combine <- the generic MSM's Horner step over its window
//       sums, ops/msm.py::combine_windows_host (:671), Python ints on the
//       host there.
//
// Their plain versions are ops/g1_ops.py accumulate_chunks, reduce_chunks
// and combine_windows: the kernels equal them limb for limb, Z included,
// and an MSM equals the JAX package's in affine form. The fixed-base MSM
// runs the first two over the table's rows; the generic MSM runs them
// over its N points, one blob a window (the blob's members are the N
// points, its digits that window's), then the combine.
//
// The work split. JAX deals each bucket's members round-robin to G lane
// groups, so a lane's chain is ceil(k_j / G) madds, and digits that crowd
// into few buckets lengthen it without bound: a blob of 4096 elements
// 0x0101..01 puts all 131,072 members of c = 8 into bucket 1, and the
// generic MSM's 255-bit top window at c = 12 puts 2^20 members into 8
// buckets. JAX answers with its top-window alias split (msm.py
// prepare_digits); the port's one 2^c grid over all windows (the window
// weights are in the table) has no alias buckets, so the balance lives
// here. Each blob's digit-sorted members are cut into chunks of at most L
// that never cross a bucket boundary (bucket j with k_j members has
// ceil(k_j / L) chunks, bucket 0 none: weight 0, and invalid members land
// there), and each chunk is one lane: at most L madds, whatever the
// digits. A blob has at most ceil(M / L) + 2^c chunks, so both kernels are
// launched at that bound (K slots a blob, a multiple of 128) with no host
// read of the counts. Each block makes the plan from bstart itself: a
// block scan of the 2^c chunk counts into shared memory (chunk_prefix),
// then a binary search per lane for its bucket.
//
// g1_bucket_accumulate: one chunk a thread, on fp.cuh (g1::jac_madd), its
// partial kept in registers and written once to its slot as a 144-byte row
// (X, Y, Z words); a slot past the blob's chunks gets infinity. The next
// member's 96-byte row is fetched with cp.async into a per-thread double
// buffer in shared memory while the current madd runs. What bounds it is
// one thread's chain of L madds (a madd is 11 products at ~2,930 cycles):
// at B = 1 the blob's ~16,600 lanes at L = 8 fill ~1 block of 128 threads
// an SM. A lane on a pair of fpc groups (8 threads, a madd 6 products
// deep) was measured too and lost at every L from 4 to 32, at B = 1 and 6
// (it spends about twice the instructions a madd and holds 8 times the
// threads a lane); so did a third block an SM (launch bounds (128, 3):
// spills, no gain). L comes from the caller (ops/msm.py chunk_length):
// 8 for the commit path, more where the members are so many that the
// IMADs bound the accumulation and the merge would only grow.
//
// g1_bucket_reduce: the merge, then the fold, on the cooperative field
// (g1c::cjac_add / cjac_dbl, a pair of fpc groups a point op, ~8 products
// deep an add), one cooperative launch of as many
// blocks of 64 pairs as the card holds at once, a group of blocks a blob;
// a blob's blocks meet at barriers of their own (blob_sync).
//   - The merge sums each bucket's chunk partials pairwise in chunk order,
//     a tree of depth ceil(log2 chunks), a level at a time: at level l the
//     node of chunks (2i + 1) 2^(l-1) .. goes into the node at 2i 2^(l-1),
//     in place in the partials, each node's sum in its leftmost chunk's
//     slot. A block scan counts each bucket's adds of the level, and add k
//     goes to worker k mod W (W: the blob's workers), so the level's adds
//     spread evenly over the blob's blocks whatever the digits; a barrier
//     ends each level. (A first design let each worker climb from a leaf
//     while it arrived second on a per-node flag, with no barrier: the
//     merge took the time of the unluckiest worker's climbs, and the
//     reduce 1.57 ms at B = 6, L = 8, against 0.50 ms this way on an H100,
//     scripts/bench_msm_kernels.py.)
//   - The fold: the blob's 2^c bucket sums (a chunk-0 slot, or infinity)
//     folded as ops/g1_ops.fold_reduce defines it: step s (s = 0 .. c-2)
//     runs fold round s (h = 2^(c-1-s) adds a_i + a_{i+h}) with the first
//     tree level of that round's high half and the next level of every
//     earlier round's tree, spread over the blob's workers, a barrier after
//     each step; then one pair runs the Horner combine sum_r 2^(c-r) E_r.
//     Its 3 2^(c-1) points live in a global scratch a blob, which stays in
//     L2 (55 KB at c = 8, 885 KB at c = 12).
//   The reduce's point ops are out of line (add_pts, dbl_pt): inlined at
//   each call they crowd the instruction cache, as fp::mul did. There are
//   no lane groups left: they spread the old accumulation, and a fold per
//   group only added work and a group tree to the chain.
//
// g1_window_combine: each MSM's W window sums -> sum_w 2^(c w) S_w by
// Horner (acc = S_{W-1}, then per window c doublings and an add), one
// MSM a pair of fpc groups on the cooperative field (~1,570 cycles a
// dependent product against fp.cuh's ~2,930), four MSMs a warp. The
// chain is c (W - 1) doublings (4 products deep each) and W - 1 adds (8
// deep): 248 to 252 doublings for 255-bit scalars at c = 4, 8 or 12,
// ~1,200 to 1,500 dependent products whatever the design, so the kernel
// is latency-bound at any B; a batch puts its MSMs on other pairs at no
// cost to the chain.
//
// What bounds them on the card: a random blob at c = 8 is ~128,500 madds
// (~46 us of IMADs at the card's peak against ~4 us of bytes) and ~16,000
// merge adds at L = 8 with a ~509-add fold. At B = 1 both kernels stay
// chain-bound: L madds a lane; then the merge's ~7 levels, the fold's c - 1
// steps and its c - 1 Horner steps, each a chain of dependent products,
// which no digit pattern lengthens. A batch of blobs puts B times the
// lanes on the card and shares its workers among the blobs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"
#include "g1_coop.cuh"

namespace {

using fp::Fp;
using fpc::Fq;
using g1::Jac;
using g1c::CJac;

constexpr int kMaxBuckets = 1 << 12;  // 2^c for c <= 12
constexpr int kPair = 2 * fpc::kT;    // threads of a cooperative lane
constexpr int kThreadBlock = 128;     // the accumulation: 128 lanes a block
constexpr int kReduceBlock = 512;     // the reduce: 64 workers a block
constexpr int kWorkers = kReduceBlock / kPair;
constexpr int kCombineBlock = 32;     // the combine: a warp, four MSMs
constexpr int kRowVecs = 6;           // a table row: x, y = 24 words = 6 x 16 bytes
constexpr int kPointVecs = 9;         // a Jacobian row: X, Y, Z = 36 words
constexpr int kPoint = 3 * fp::NL;

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

// Exclusive scan of v(j), j < n, into S[0 .. n] in shared memory; returns
// S[n], the total. Every thread of the block (a multiple of 32 threads)
// calls it; it reads and writes S only between its barriers.
template <class F>
__device__ int block_scan(int n, F v, int* S, int* warp_sums) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int per = (n + nthr - 1) / nthr;  // a run of entries a thread
  const int j0 = min(tid * per, n), j1 = min(j0 + per, n);
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += v(j);
  const int lane = tid & 31, warp = tid >> 5;
  int x = mine;  // inclusive scan across the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();  // an earlier scan's S and warp sums are read no more
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int run = x - mine;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int j = j0; j < j1; ++j) {
    S[j] = run;
    run += v(j);
  }
  if (tid == nthr - 1) S[n] = run;  // the last thread's run ends at the total
  __syncthreads();
  return S[n];
}

// The chunk plan of one blob in shared memory: P[j] = the sum over i < j
// of ceil(k_i / L), k_i bucket i's members (k_0 taken as 0), for j <= 2^c
// -> P[2^c], the blob's chunks
__device__ __forceinline__ int chunk_prefix(const int32_t* __restrict__ bs, int M, int nb, int L,
                                            int* P, int* warp_sums) {
  return block_scan(nb, [&](int j) {
    const int end = j + 1 < nb ? bs[j + 1] : M;
    return j ? (end - bs[j] + L - 1) / L : 0;
  }, P, warp_sums);
}

// The `per_blob` blocks of a blob meet here (co-resident: the reduce is a
// cooperative launch). `count` (zero at the launch) gains one a block a
// barrier; `epoch` counts the arrivals this barrier waits for. The
// block's stores before it are visible to the blob's blocks after it.
__device__ void blob_sync(int* count, int& epoch, int per_blob) {
  __syncthreads();
  if (per_blob == 1) return;
  epoch += per_blob;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1);
    for (;;) {
      int seen;
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (seen >= epoch) break;
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// The reduce's point ops, one copy each: inlined at every call they
// overflow the instruction cache (as fp::mul did, fp.cuh)
__device__ __noinline__ CJac add_pts(CJac p, CJac q, bool live) { return g1c::cjac_add(p, q, live); }
__device__ __noinline__ CJac dbl_pt(CJac p) { return g1c::cjac_dbl(p); }

// the largest j with P[j] <= s: for s below the total, the bucket of chunk
// s (an empty bucket's P equals the next one's)
__device__ __forceinline__ int bucket_of(const int* P, int nb, int s) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (P[mid] <= s) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void words_to_fp(Fp& f, int k0, const uint4& v) {
  f.v[k0] = v.x;
  f.v[k0 + 1] = v.y;
  f.v[k0 + 2] = v.z;
  f.v[k0 + 3] = v.w;
}

__device__ __forceinline__ void st_pt(uint4* p, const Jac& a) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = make_uint4(a.X.v[4 * k], a.X.v[4 * k + 1], a.X.v[4 * k + 2], a.X.v[4 * k + 3]);
    p[3 + k] = make_uint4(a.Y.v[4 * k], a.Y.v[4 * k + 1], a.Y.v[4 * k + 2], a.Y.v[4 * k + 3]);
    p[6 + k] = make_uint4(a.Z.v[4 * k], a.Z.v[4 * k + 1], a.Z.v[4 * k + 2], a.Z.v[4 * k + 3]);
  }
}

// this thread's words of a 36-word point row, read through L2 (the rows
// are written by other blocks and launches)
__device__ __forceinline__ CJac ld_row(const uint32_t* p) {
  const int o = fpc::rank() * fpc::kS;
  CJac r;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    r.X.v[k] = __ldcg(p + o + k);
    r.Y.v[k] = __ldcg(p + fp::NL + o + k);
    r.Z.v[k] = __ldcg(p + 2 * fp::NL + o + k);
  }
  return r;
}

__device__ __forceinline__ void st_row(uint32_t* p, const CJac& a) {
  const int o = fpc::rank() * fpc::kS;
#pragma unroll
  for (int k = 0; k < fpc::kS; ++k) {
    p[o + k] = a.X.v[k];
    p[fp::NL + o + k] = a.Y.v[k];
    p[2 * fp::NL + o + k] = a.Z.v[k];
  }
}

// One chunk a thread: slot s of blob b is thread s of the blob's K.
__global__ void __launch_bounds__(kThreadBlock)
    g1_bucket_accumulate_kernel(const uint4* __restrict__ table,
                                       const int32_t* __restrict__ order,
                                       const int32_t* __restrict__ bstart,
                                       uint4* __restrict__ out, int M, int c, int L, int K) {
  __shared__ int P[kMaxBuckets + 1];
  __shared__ int warp_sums[32];
  __shared__ uint4 rows[2][kRowVecs][kThreadBlock];
  const int tid = threadIdx.x;
  const int blocks = K / kThreadBlock;
  const int b = blockIdx.x / blocks;
  const int s = (blockIdx.x - b * blocks) * kThreadBlock + tid;
  const int nb = 1 << c;
  const int32_t* bs = bstart + (size_t)b * nb;
  const int total = chunk_prefix(bs, M, nb, L, P, warp_sums);
  Jac acc = g1::jac_zero();
  if (s < total) {
    const int j = bucket_of(P, nb, s);
    const int start = bs[j] + (s - P[j]) * L;
    const int n = min(L, (j + 1 < nb ? bs[j + 1] : M) - start);
    const int32_t* ord = order + (size_t)b * M + start;
    auto fetch = [&](int t, int stage) {
      const uint4* src = table + (size_t)ord[t] * kRowVecs;
#pragma unroll
      for (int k = 0; k < kRowVecs; ++k) cp_async16(&rows[stage][k][tid], src + k);
    };
    fetch(0, 0);
    cp_async_commit();
    for (int t = 0; t < n; ++t) {
      if (t + 1 < n) fetch(t + 1, (t + 1) & 1);
      cp_async_commit();  // one group per round, empty on the last
      cp_async_wait_prev();
      Fp X, Y;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        words_to_fp(X, 4 * k, rows[t & 1][k][tid]);
        words_to_fp(Y, 4 * k, rows[t & 1][3 + k][tid]);
      }
      acc = g1::jac_madd(acc, X, Y);  // the first member lifts (Z = 1)
    }
  }
  st_pt(out + ((size_t)b * K + s) * kPointVecs, acc);
}

// A blob to each group of `per_blob` blocks of 64 workers (pairs of
// groups), W = per_blob 64 workers a blob; a group takes blob b, then b +
// the groups, .. . `work` holds a barrier count a blob, zeroed by the
// caller.
__global__ void __launch_bounds__(kReduceBlock, 1)
    g1_bucket_reduce_kernel(uint32_t* __restrict__ part, const int32_t* __restrict__ bstart,
                            int* __restrict__ work, uint32_t* __restrict__ scratch,
                            uint32_t* __restrict__ out, int M, int c, int L, int K, int B,
                            int per_blob) {
  __shared__ int P[kMaxBuckets + 1];  // each bucket's first chunk slot
  __shared__ int Q[kMaxBuckets + 1];  // each bucket's first add of a merge level
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x;
  const int W = per_blob * kWorkers;
  const int me = (blockIdx.x % per_blob) * kWorkers + tid / kPair;
  const bool head = blockIdx.x % per_blob == 0;
  const int nb = 1 << c;
  for (int b = blockIdx.x / per_blob; b < B; b += gridDim.x / per_blob) {
    const int32_t* bs = bstart + (size_t)b * nb;
    uint32_t* pb = part + (size_t)b * K * kPoint;
    int epoch = 0;
    chunk_prefix(bs, M, nb, L, P, warp_sums);

    // the merge, a level at a time: at level l (half = 2^(l-1)) bucket j
    // adds the node of chunks i 2 half + half .. into the node at i 2 half,
    // for each such i below its chunk count; add k of the level goes to
    // worker k mod W
    for (int half = 1;; half *= 2) {
      const int adds = block_scan(nb, [&](int j) {
        const int n = P[j + 1] - P[j];
        return n > half ? (n - half - 1) / (2 * half) + 1 : 0;
      }, Q, warp_sums);
      if (adds == 0) break;  // the same at every block of the blob
      for (int base = 0; base < adds; base += W) {
        const int k = base + me;
        const bool live = k < adds;
        size_t left = 0, right = 0;
        if (live) {
          const int j = bucket_of(Q, nb, k);
          left = P[j] + (size_t)(k - Q[j]) * 2 * half;
          right = left + half;
        }
        if (fpc::warp_any(live)) {
          const CJac sum = add_pts(ld_row(pb + left * kPoint), ld_row(pb + right * kPoint), live);
          if (live && !fpc::second()) st_row(pb + left * kPoint, sum);
        }
      }
      blob_sync(work + b, epoch, per_blob);
    }

    // the fold of bucket sums a[0 .. 2^c) (a[0] and empty buckets
    // infinity); tree region T_r of round r (h_r = 2^(c-1-r) high-half
    // entries, h_r / 2 tree entries) starts at T + 2^(c-1) - h_r
    uint32_t* a = scratch + (size_t)b * (3 << (c - 1)) * kPoint;
    uint32_t* T = a + (size_t)nb * kPoint;
    for (int j = me; j < nb; j += W) {
      CJac p = g1c::cjac_zero();
      if (j && P[j + 1] > P[j]) p = ld_row(pb + (size_t)P[j] * kPoint);
      if (!fpc::second()) st_row(a + (size_t)j * kPoint, p);
    }
    blob_sync(work + b, epoch, per_blob);
    for (int st = 0; st + 2 <= c; ++st) {
      const int h = nb >> (st + 1);  // fold round st: a_i += a_{i+h}, i < h
      const int q = h >> 1;          // every tree level at this step is q wide
      const int items = h + (st + 1) * q;
      for (int base = 0; base < items; base += W) {
        const bool act = base + me < items;
        if (!fpc::warp_any(act)) continue;
        const int it = act ? base + me : items - 1;  // an idle worker adds again, stores nothing
        const uint32_t *x, *y;
        uint32_t* dst;
        if (it < h) {
          dst = a + (size_t)it * kPoint;
          x = dst;
          y = a + (size_t)(it + h) * kPoint;
        } else {
          const int k = it - h;
          const int r = k / q;  // round r's tree, at level st - r + 1
          const int e = k - r * q;
          uint32_t* Tr = T + (size_t)((nb >> 1) - (nb >> (r + 1))) * kPoint;
          dst = Tr + (size_t)e * kPoint;
          if (r == st) {  // level 1 reads round st's high half, as the fold does
            x = a + (size_t)(h + e) * kPoint;
            y = a + (size_t)(h + e + q) * kPoint;
          } else {
            x = dst;
            y = Tr + (size_t)(e + q) * kPoint;
          }
        }
        const CJac sum = add_pts(ld_row(x), ld_row(y), act);
        if (act && !fpc::second()) st_row(dst, sum);
      }
      blob_sync(work + b, epoch, per_blob);
    }
    if (head && tid < 32) {
      // the Horner combine on warp 0 of the blob's first block (its four
      // pairs alike); E_r is round r's high-half total, and h_r = 1
      // (r = c - 1) is a[1] itself
      auto total_of = [&](int r) {
        const int hr = nb >> (r + 1);
        return ld_row(hr >= 2 ? T + (size_t)((nb >> 1) - hr) * kPoint : a + kPoint);
      };
      CJac acc = total_of(0);
      for (int r = 1; r < c; ++r) acc = add_pts(dbl_pt(acc), total_of(r), true);
      if (tid < fpc::kT) g1c::store_cjac(out, B, b, acc);
    }
  }
}

// One MSM a pair of groups, windows of MSM b at columns b W .. b W + W - 1
// of the [3, 12, B W] sums; a pair past the last MSM runs the last one's
// chain again and stores nothing (every thread of the warp runs every
// field op).
__global__ void __launch_bounds__(kCombineBlock)
    g1_window_combine_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out,
                             int B, int W, int c) {
  const int m = blockIdx.x * (kCombineBlock / kPair) + threadIdx.x / kPair;
  const bool live = m < B;
  const int b = live ? m : B - 1;
  const int M = B * W;
  CJac acc = g1c::load_cjac(sums, M, b * W + W - 1);
  for (int w = W - 2; w >= 0; --w) {
    for (int d = 0; d < c; ++d) acc = dbl_pt(acc);
    acc = add_pts(acc, g1c::load_cjac(sums, M, b * W + w), true);
  }
  if (live && !fpc::second()) g1c::store_cjac(out, B, b, acc);
}

}  // namespace

// Launchers: raw device pointers, sizes and a cudaStream_t. Each returns
// cudaGetLastError() after its launch (0 on success). K (chunk slots a
// blob) is a multiple of 128.
extern "C" int lwkzg_g1_bucket_accumulate(const void* table, const void* order,
                                          const void* bstart, void* out, int n_members,
                                          int c, int chunk, int K, int B, void* stream) {
  g1_bucket_accumulate_kernel<<<B * (K / kThreadBlock), kThreadBlock, 0,
                                (cudaStream_t)stream>>>(
      (const uint4*)table, (const int32_t*)order, (const int32_t*)bstart, (uint4*)out,
      n_members, c, chunk, K);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_g1_bucket_reduce(void* partials, const void* bstart, void* work,
                                      void* scratch, void* out, int n_members, int c,
                                      int chunk, int K, int B, void* stream) {
  // every block the card holds at once, in one group a blob while the
  // blobs are fewer, one block a blob past that; a cooperative launch, so
  // that a blob's blocks meet at its barriers
  static int resident = 0;
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, g1_bucket_reduce_kernel, kReduceBlock, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int groups = B < resident ? B : resident;
  int per_blob = resident / groups;
  uint32_t* part = (uint32_t*)partials;
  const int32_t* bs = (const int32_t*)bstart;
  int* counts = (int*)work;
  uint32_t* scr = (uint32_t*)scratch;
  uint32_t* o = (uint32_t*)out;
  void* args[] = {&part, &bs, &counts, &scr, &o, &n_members, &c, &chunk, &K, &B, &per_blob};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)g1_bucket_reduce_kernel,
                                                    dim3(groups * per_blob), dim3(kReduceBlock),
                                                    args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// sums [3, 12, B W] -> out [3, 12, B]
extern "C" int lwkzg_g1_window_combine(const void* sums, void* out, int B, int W, int c,
                                       void* stream) {
  constexpr int per_block = kCombineBlock / kPair;
  g1_window_combine_kernel<<<(B + per_block - 1) / per_block, kCombineBlock, 0,
                             (cudaStream_t)stream>>>((const uint32_t*)sums, (uint32_t*)out, B, W,
                                                     c);
  return (int)cudaGetLastError();
}
