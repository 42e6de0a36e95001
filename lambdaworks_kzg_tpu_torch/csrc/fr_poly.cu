// The Fr polynomial kernels for Hopper (sm_90a), on the scalar field of
// fr.cuh: fr_evaluate, fr_quotient, fr_quotient_in_domain, and the
// elementwise fr_to_mont and fr_check.
//
// They replace the three programs the JAX package jits once per domain
// size, lambdaworks_kzg_tpu/ops/fr_poly.py:
//   fr_evaluate           <- FrDomain._eval_kernel (:66)
//       y = (z^n - 1) / n * sum_i e_i w_i / (z - w_i)
//   fr_quotient           <- FrDomain._quotient_kernel (:82)
//       q_i = (e_i - y) / (w_i - z), plain
//   fr_quotient_in_domain <- FrDomain._quotient_in_domain_kernel (:94)
//       z = w_m: q_i as above for i != m, and
//       q_m = sum_{i != m} (e_i - y) w_i / (z (z - w_i)), y = e_m
// and fr_to_mont the XLA FR.to_mont (lambdaworks_kzg_tpu/ops/field_ops.py
// :97) that puts a batch's evaluations into Montgomery form before them.
// fr_check returns the field's product, square, sum, difference,
// negation, inverse and both conversions, to hold fr.cuh against the
// plain field (ops/field_ops.py FR) on the card.
//
// Layout. fr_evaluate and fr_quotient take the plain evaluations as the
// public layout, int64 radix-2^16 limbs [B, 16, n] (limb j of blob b's
// element i at (b 16 + j) n + i), and give the plain y [B, 16, 1] and
// quotients [B, 16, n] in it, so no conversion of layout or form runs
// around them (a Montgomery product of a plain value by a Montgomery one
// is plain). Beside them, limbs-first u32 arrays in
// Montgomery form with R = 2^256: the roots w_i in bit-reversed order
// [8, n], 1/n [8, 1], and a table of each blob's z [B, 8, L + 1], L =
// log2 n, all of it made on the host and only read here: column l < L
// z^(2^l), column L the quotient's K = 1 / (z^n - 1) (0 where z^n = 1),
// so that plain evaluations and y give plain quotients. fr_quotient_in_domain
// and fr_to_mont keep u32 arrays [B, 8, n] (one value per blob [B, 8, 1],
// the in-domain index m as int32[B]).
//
// Design of fr_evaluate and fr_quotient: no inversion on the card. The
// domain's n roots of unity in bit-reversed order fall into aligned chunks:
// the chunk of index g at size m = 2^l is the coset c H_m, so the product
// of its denominators is Prod (z - w_i) = z^m - c^m, and c^m = w_g, the
// root stored at index g. Every node of a binary tree over the elements
// thus knows its denominator in closed form, one subtraction from the
// power z^(2^l) of its level.
//   fr_evaluate: y = (1/n) N, N = sum_i e_i w_i Prod_{j != i} (z - w_j), the
//   numerator of the fraction sum sum_i e_i w_i / (z - w_i) over
//   Prod_j (z - w_j) = z^n - 1 (at z = w_m, N = n e_m and y = e_m exactly).
//   Up the tree a node's numerator is N_left D_right + N_right D_left: two
//   independent products, taken by two threads.
//   fr_quotient: q_i = (y - e_i) / (z - w_i), and 1 / (z - w_i) = K Prod of
//   the denominators of the chunks that are siblings of i's on its path to
//   the root, K = 1 / (z^n - 1) from the host. Down the tree a node's
//   1 / (its denominator) is its parent's times its sibling's denominator:
//   one product.
// A blob runs on G blocks of T = min(n, 256) threads, k = n / (G T)
// consecutive elements a thread: G = 8 from n = 2048 on (n = 4096: 8
// blocks, 2 elements a thread), else 1. A thread folds its k elements by
// their paths inside its chunk (log2 k products each); the block runs the
// tree over its T threads in shared memory. fr_evaluate's G blocks are one
// thread block cluster (its size fixed at compile time, so the launch is
// a plain one that the profiler sees), and the first block reads the
// others' numerators from their shared memory (distributed shared memory)
// for the last log2 G levels; fr_quotient's blocks need nothing of each
// other: a block's 1 / (its denominator) is K times its log2 G siblings'
// denominators. Each block reads the powers z^(2^l) from the table into
// shared memory first, so neither kernel squares and neither depends on
// the other having run.
// Every result is canonical, so the order of the products does not
// matter: the outputs equal the plain PyTorch versions (ops/fr_poly.py)
// bit for bit.
//
// fr_quotient_in_domain keeps its first design: one block of T = min(n,
// 256) threads per blob, Montgomery's trick on two levels (each thread's
// prefix products, a shared tree of the T partials, one Fermat inversion
// by one thread, fr::inv, back down), the zero denominator at m set to one
// for the inversion and its inverse to zero, as ops/fr_poly.py does.
//
// What bounds them: the functions need, a blob of n = 4096, its n values
// in (128 KB as 32-byte elements; the public limbs the kernels read hold
// each in 128 bytes, 512 KB) and, for the quotient, n out; fr_evaluate
// 2 n + 1 products, ~2.2 M IMADs, fr_quotient 3 n - 2 and one inversion,
// ~3.3 M: by operations ~0.13 us and ~0.2 us a blob on the card. The
// launch is bound instead by its chain: fr_evaluate a thread's 2 elements
// (2 dependent products), then 8 levels in the block and 3 in the
// cluster, one product and two barriers each, and the product by 1/n;
// fr_quotient 3 products for the block's root, 8 levels down and 2
// products a thread -- ~15 dependent products of ~1,300 cycles each.
// fr_quotient_in_domain is bound by its Fermat chain (252 squarings, 73
// products) and each thread's 16 elements on one SM (ROADMAP queue B
// item 0).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

namespace cg = cooperative_groups;

using fr::Fr;

constexpr int kMaxThreads = 256;  // threads a blob's block; the tree's leaves
constexpr int kCluster = 8;  // fr_evaluate's and fr_quotient's blocks a blob from n = 2048 on
constexpr int kMaxLevels = 31;    // log2 n

inline int threads_for(int n) { return n < kMaxThreads ? n : kMaxThreads; }

inline int log2_of(int x) {  // x a power of two
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The inverses of the block's n denominators denom(i) (none zero; a zero
// gives zero inverses) by Montgomery's trick on two levels, handed to
// use(i, 1 / denom(i)) element by element as each thread walks back.
// pre: this blob's [8, n] scratch for the prefix products; use may write
// element i of it (it is read there before). node and inv: shared arrays
// of 2 kMaxThreads, a heap of T leaves (node j's children 2j, 2j + 1).
template <class Denom, class Use>
__device__ void batch_inverse(int n, uint32_t* pre, Fr* node, Fr* inv, Denom denom, Use use) {
  const int T = blockDim.x, t = threadIdx.x, per = n / T;
  Fr acc = fr::one();
  for (int k = 0; k < per; ++k) {
    const int i = t + k * T;
    acc = fr::mul(acc, denom(i));
    fr::store(pre, n, i, acc);
  }
  node[T + t] = acc;
  __syncthreads();
  for (int h = T / 2; h >= 1; h >>= 1) {
    if (t < h) node[h + t] = fr::mul(node[2 * (h + t)], node[2 * (h + t) + 1]);
    __syncthreads();
  }
  if (t == 0) inv[1] = fr::inv(node[1]);
  __syncthreads();
  for (int h = 1; h < T; h <<= 1) {
    if (t < h) {
      const int j = h + t;
      const Fr up = inv[j];
      inv[2 * j] = fr::mul(up, node[2 * j + 1]);
      inv[2 * j + 1] = fr::mul(up, node[2 * j]);
    }
    __syncthreads();
  }
  Fr acc_inv = inv[T + t];  // 1 / (the product of this thread's denominators)
  for (int k = per - 1; k >= 0; --k) {
    const int i = t + k * T;
    Fr inv_i = acc_inv;
    if (k) {
      inv_i = fr::mul(acc_inv, fr::load(pre, n, i - T));
      acc_inv = fr::mul(acc_inv, denom(i));
    }
    use(i, inv_i);
  }
}

// The block's sum of each thread's part, left in node[0] for thread 0.
// node must be free: batch_inverse reads it last before its final barrier.
__device__ void block_sum(Fr part, Fr* node) {
  const int t = threadIdx.x;
  node[t] = part;
  __syncthreads();
  for (int h = blockDim.x / 2; h >= 1; h >>= 1) {
    if (t < h) node[t] = fr::add(node[t], node[t + h]);
    __syncthreads();
  }
}

// Element i of a blob's [16, n] int64 radix-2^16 limbs (the public
// layout) as eight words, and back.
__device__ __forceinline__ Fr load16(const int64_t* __restrict__ base, int n, int i) {
  Fr a;
#pragma unroll
  for (int k = 0; k < fr::NL; ++k)
    a.v[k] = (uint32_t)base[(size_t)(2 * k) * n + i] |
             ((uint32_t)base[(size_t)(2 * k + 1) * n + i] << 16);
  return a;
}

__device__ __forceinline__ void store16(int64_t* __restrict__ base, int n, int i, const Fr& a) {
#pragma unroll
  for (int k = 0; k < fr::NL; ++k) {
    base[(size_t)(2 * k) * n + i] = a.v[k] & 0xffffu;
    base[(size_t)(2 * k + 1) * n + i] = a.v[k] >> 16;
  }
}

// acc times the product of (z - w_j) over the j != i of i's aligned chunk
// of 2^levels elements: per level l below, the chunk that is the sibling
// of i's at size 2^l, whose product is pw[l] - w_((i >> l) ^ 1), pw[l] =
// z^(2^l).
__device__ Fr chunk_complement(Fr acc, int i, int levels, const Fr* pw,
                               const uint32_t* __restrict__ roots, int n) {
  for (int l = 0; l < levels; ++l) acc = fr::mul(acc, fr::sub(pw[l], fr::load(roots, n, (i >> l) ^ 1)));
  return acc;
}

// The fraction tree up: num[0 .. count) are the numerators of count
// consecutive chunks at size 2^level, the first of them of index first
// (even); on return num[0] is the numerator of their union. A node's is
// N_left D_right + N_right D_left with D_left = z^(2^level) - c and
// D_right = z^(2^level) + c, c = w_(its left child's index) (the right
// child's root is -c), thread u of 2 h taking one of the two products of
// node u / 2; pw[l] = z^(2^l).
__device__ void fraction_up(Fr* num, Fr* prod, const Fr* pw, int count, int level, int first,
                            const uint32_t* __restrict__ roots, int n) {
  const int t = threadIdx.x;
  for (int h = count >> 1; h >= 1; h >>= 1, ++level, first >>= 1) {
    if (t < 2 * h) {
      const Fr c = fr::load(roots, n, first + (t & ~1));
      prod[t] = fr::mul(num[t], (t & 1) ? fr::sub(pw[level], c) : fr::add(pw[level], c));
    }
    __syncthreads();
    if (t < h) num[t] = fr::add(prod[2 * t], prod[2 * t + 1]);
    __syncthreads();
  }
}

// A blob of n on a cluster of G blocks of T threads, 2^lk elements a
// thread (the launcher's split); block rank r owns the elements
// [r T 2^lk, (r + 1) T 2^lk).
template <int G>
__device__ void evaluate_blob(const int64_t* __restrict__ evals, const uint32_t* __restrict__ table,
                              const uint32_t* __restrict__ roots, const uint32_t* __restrict__ n_inv,
                              int64_t* __restrict__ out, int n, int lk) {
  __shared__ Fr num[kMaxThreads], prod[kMaxThreads], pw[kMaxLevels];
  const int T = blockDim.x, t = threadIdx.x, lt = 31 - __clz(T), lg = 31 - __clz(G);
  const int rank = blockIdx.x % G, b = blockIdx.x / G;
  const int L = lk + lt + lg, W = L + 1;
  const uint32_t* tab = table + (size_t)b * fr::NL * W;
  const int64_t* e = evals + (size_t)b * 2 * fr::NL * n;
  if (t < L) pw[t] = fr::load(tab, W, t);
  __syncthreads();
  Fr part = fr::zero();
  for (int r = 0; r < (1 << lk); ++r) {
    const int i = ((rank * T + t) << lk) + r;
    const Fr leaf = fr::mul(load16(e, n, i), fr::load(roots, n, i));
    part = fr::add(part, chunk_complement(leaf, i, lk, pw, roots, n));
  }
  num[t] = part;
  __syncthreads();
  fraction_up(num, prod, pw, T, lk, rank * T, roots, n);
  if constexpr (G > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's numerator is in its num[0]
    if (rank == 0 && t < G) num[t] = *cluster.map_shared_rank(num, t);
    cluster.sync();  // read: the other blocks may leave
    if (rank) return;
    fraction_up(num, prod, pw, G, lk + lt, 0, roots, n);
  }
  if (t == 0) store16(out + (size_t)b * 2 * fr::NL, 1, 0, fr::mul(num[0], fr::load(n_inv, 1, 0)));
}

__global__ void __launch_bounds__(kMaxThreads)
    fr_evaluate_kernel(const int64_t* __restrict__ evals, const uint32_t* __restrict__ table,
                       const uint32_t* __restrict__ roots, const uint32_t* __restrict__ n_inv,
                       int64_t* __restrict__ out, int n, int lk) {
  evaluate_blob<1>(evals, table, roots, n_inv, out, n, lk);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
    fr_evaluate_cluster_kernel(const int64_t* __restrict__ evals, const uint32_t* __restrict__ table,
                               const uint32_t* __restrict__ roots,
                               const uint32_t* __restrict__ n_inv, int64_t* __restrict__ out, int n,
                               int lk) {
  evaluate_blob<kCluster>(evals, table, roots, n_inv, out, n, lk);
}

// The same split, each block on its own.
__global__ void __launch_bounds__(kMaxThreads)
    fr_quotient_kernel(const int64_t* __restrict__ evals, const int64_t* __restrict__ y,
                       const uint32_t* __restrict__ table, const uint32_t* __restrict__ roots,
                       int64_t* __restrict__ out, int n, int lk, int lg) {
  // comp[v]: 1 / (the denominator of the block tree's node v), a heap of
  // T leaves (node v's children 2v, 2v + 1)
  __shared__ Fr comp[2 * kMaxThreads], pw[kMaxLevels];
  const int T = blockDim.x, t = threadIdx.x, lt = 31 - __clz(T);
  const int rank = blockIdx.x & ((1 << lg) - 1), b = blockIdx.x >> lg;
  const int lb = lk + lt, L = lb + lg, W = L + 1;
  const uint32_t* tab = table + (size_t)b * fr::NL * W;
  if (t < L) pw[t] = fr::load(tab, W, t);
  __syncthreads();
  if (t == 0) {  // K times the denominators of the block's siblings above it
    Fr c = fr::load(tab, W, L);
    for (int l = lb; l < L; ++l)
      c = fr::mul(c, fr::sub(pw[l], fr::load(roots, n, (rank >> (l - lb)) ^ 1)));
    comp[1] = c;
  }
  __syncthreads();
  // children 2h .. 4h - 1 at size 2^level; child 2h + u is the chunk
  // rank 2h + u, its sibling rank 2h + (u ^ 1)
  for (int h = 1, level = lb - 1; h < T; h <<= 1, --level) {
    if (t < 2 * h)
      comp[2 * h + t] = fr::mul(comp[h + (t >> 1)],
                                fr::sub(pw[level], fr::load(roots, n, rank * 2 * h + (t ^ 1))));
    __syncthreads();
  }
  const Fr mine = comp[T + t];  // 1 / (the product over this thread's elements)
  const Fr yb = load16(y + (size_t)b * 2 * fr::NL, 1, 0);
  const int64_t* e = evals + (size_t)b * 2 * fr::NL * n;
  int64_t* q = out + (size_t)b * 2 * fr::NL * n;
  for (int r = 0; r < (1 << lk); ++r) {
    const int i = ((rank * T + t) << lk) + r;
    const Fr inv_i = chunk_complement(mine, i, lk, pw, roots, n);  // 1 / (z - w_i)
    store16(q, n, i, fr::mul(fr::sub(yb, load16(e, n, i)), inv_i));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    fr_quotient_in_domain_kernel(const uint32_t* __restrict__ evals,
                                 const int32_t* __restrict__ m_idx,
                                 const uint32_t* __restrict__ z_inv,
                                 const uint32_t* __restrict__ roots, uint32_t* out, int n) {
  __shared__ Fr node[2 * kMaxThreads];
  __shared__ Fr inv[2 * kMaxThreads];
  const int b = blockIdx.x;
  const uint32_t* e = evals + (size_t)b * fr::NL * n;
  uint32_t* q = out + (size_t)b * fr::NL * n;  // also the prefix products
  const int m = m_idx[b];  // in [0, n): the wrapper checks
  const Fr y = fr::load(e, n, m);
  const Fr zb = fr::load(roots, n, m);
  Fr part = fr::zero();
  batch_inverse(
      n, q, node, inv,
      [&](int i) { return i == m ? fr::one() : fr::sub(fr::load(roots, n, i), zb); },
      [&](int i, const Fr& inv_i) {
        const Fr d = i == m ? fr::zero() : inv_i;  // 1 / (w_i - z), 0 at m
        const Fr shifted = fr::sub(fr::load(e, n, i), y);
        fr::store(q, n, i, fr::from_mont(fr::mul(shifted, d)));
        // 1 / (z - w_i) = -d
        part = fr::add(part, fr::mul(fr::mul(shifted, fr::load(roots, n, i)), fr::neg(d)));
      });
  block_sum(part, node);
  if (threadIdx.x == 0)
    fr::store(q, n, m, fr::from_mont(fr::mul(node[0], fr::load(z_inv + b * fr::NL, 1, 0))));
}

// element i of each of the B [8, n] arrays, one thread each
__global__ void __launch_bounds__(kMaxThreads)
    fr_to_mont_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int B, int n) {
  const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long)B * n) return;
  const size_t base = (size_t)(g / n) * fr::NL * n;
  const int i = (int)(g % n);
  fr::store(out + base, n, i, fr::to_mont(fr::load(a + base, n, i)));
}

// lane m of two [8, M] arrays of values below r -> out [8, 8, M]: mul(a,
// b), sqr(a), add(a, b), sub(a, b), neg(a), inv(a), to_mont(a), from_mont(a)
__global__ void __launch_bounds__(kMaxThreads)
    fr_check_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const Fr x = fr::load(a, M, m), y = fr::load(b, M, m);
  const size_t s = (size_t)fr::NL * M;
  fr::store(out, M, m, fr::mul(x, y));
  fr::store(out + s, M, m, fr::sqr(x));
  fr::store(out + 2 * s, M, m, fr::add(x, y));
  fr::store(out + 3 * s, M, m, fr::sub(x, y));
  fr::store(out + 4 * s, M, m, fr::neg(x));
  fr::store(out + 5 * s, M, m, fr::inv(x));
  fr::store(out + 6 * s, M, m, fr::to_mont(x));
  fr::store(out + 7 * s, M, m, fr::from_mont(x));
}

inline int blocks_for(long lanes) { return (int)((lanes + kMaxThreads - 1) / kMaxThreads); }

// fr_evaluate and fr_quotient: a blob of n (a power of two, at least 2) on
// G blocks of T = min(n, 256) threads, G = 8 from n = 2048 on and 1 below,
// 2^lk = n / (G T) elements a thread.
struct Split {
  int T, G, lk, lg;
};

inline Split split_for(int n) {
  Split s;
  s.T = threads_for(n);
  s.G = n >= kCluster * kMaxThreads ? kCluster : 1;
  s.lg = log2_of(s.G);
  s.lk = log2_of(n) - log2_of(s.T) - s.lg;
  return s;
}

}  // namespace

// Launchers: raw device pointers, the blob count B and the domain size n
// (a power of two), or the lane count, and a cudaStream_t. Each returns
// cudaGetLastError() after its launch (0 on success).

extern "C" int lwkzg_fr_evaluate(const void* evals, const void* table, const void* roots,
                                 const void* n_inv, void* out, int B, int n, void* stream) {
  const Split s = split_for(n);
  const auto e = (const int64_t*)evals;
  const auto tab = (const uint32_t*)table, r = (const uint32_t*)roots, ni = (const uint32_t*)n_inv;
  if (s.G == kCluster)
    fr_evaluate_cluster_kernel<<<B * s.G, s.T, 0, (cudaStream_t)stream>>>(e, tab, r, ni,
                                                                         (int64_t*)out, n, s.lk);
  else
    fr_evaluate_kernel<<<B, s.T, 0, (cudaStream_t)stream>>>(e, tab, r, ni, (int64_t*)out, n, s.lk);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fr_quotient(const void* evals, const void* y, const void* table,
                                 const void* roots, void* out, int B, int n, void* stream) {
  const Split s = split_for(n);
  fr_quotient_kernel<<<B * s.G, s.T, 0, (cudaStream_t)stream>>>(
      (const int64_t*)evals, (const int64_t*)y, (const uint32_t*)table, (const uint32_t*)roots,
      (int64_t*)out, n, s.lk, s.lg);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fr_quotient_in_domain(const void* evals, const void* m, const void* z_inv,
                                           const void* roots, void* out, int B, int n,
                                           void* stream) {
  fr_quotient_in_domain_kernel<<<B, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)evals, (const int32_t*)m, (const uint32_t*)z_inv, (const uint32_t*)roots,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fr_to_mont(const void* a, void* out, int B, int n, void* stream) {
  fr_to_mont_kernel<<<blocks_for((long)B * n), kMaxThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, B, n);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fr_check(const void* a, const void* b, void* out, int M, void* stream) {
  fr_check_kernel<<<blocks_for(M), kMaxThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, M);
  return (int)cudaGetLastError();
}
