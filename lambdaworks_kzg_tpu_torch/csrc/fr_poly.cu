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
// Layout. The three polynomial kernels take the plain evaluations as the
// public layout, int64 radix-2^16 limbs [B, 16, n] (limb j of blob b's
// element i at (b 16 + j) n + i), and give the plain y [B, 16, 1] and
// quotients [B, 16, n] in it, so no conversion of layout or form runs
// around them (a Montgomery product of a plain value by a Montgomery one
// is plain). Beside them, limbs-first u32 arrays in Montgomery form with
// R = 2^256: the roots w_i in bit-reversed order [8, n], 1/n [8, 1], and a
// table of each blob's z, all of it made on the host and only read here.
// For fr_evaluate and fr_quotient it is [B, 8, L + 1], L = log2 n: column
// l < L z^(2^l), column L the quotient's K = 1 / (z^n - 1) (0 where
// z^n = 1). For fr_quotient_in_domain, z = w_m, it is [B, 8, L + 3]:
// column l < L z^(2^l), column L K = w_m / n, column L + 1 1/z, and in
// word 0 of column L + 2 the index m. K carries R, so that plain
// evaluations and y give plain quotients. fr_to_mont keeps u32 arrays
// [B, 8, n].
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
// fr_quotient_in_domain, z = w_m, walks down the same tree as fr_quotient
// on the same split. The product of the n - 1 nonzero denominators is
// prod_{i != m} (z - w_i) = n / w_m (the derivative of X^n - 1 at w_m), so
// K = w_m / n; every sibling chunk keeps z^s - w_g but the one that holds
// m (on i's path, the sibling at the level where i's and m's paths part),
// whose product without the zero factor is s z^s / z (the derivative of
// X^s - w_g at z). So 1 / (z - w_i) for i != m comes down the tree from K
// with no inversion, the host having sent z's powers (roots, looked up)
// and 1/z (a root too). y = e_m, and q_m = -(1/z) sum_{i != m} q_i w_i:
// each block sums its elements' q_i w_i (e_m - y = 0 makes q_m's own term
// 0), and as in fr_evaluate the G blocks of a blob are one cluster, whose
// first block reads the others' sums from their shared memory.
// Every result is canonical, so the order of the products does not
// matter: the outputs equal the plain PyTorch versions (ops/fr_poly.py)
// bit for bit.
//
// What bounds them: the functions need, a blob of n = 4096, its n values
// in (128 KB as 32-byte elements; the public limbs the kernels read hold
// each in 128 bytes, 512 KB) and, for the quotients, n out; fr_evaluate
// 2 n + 1 products, ~2.2 M IMADs, fr_quotient 3 n - 2 and one inversion,
// ~3.3 M, fr_quotient_in_domain 4 n - 1 + L, ~4.3 M: by operations
// ~0.13 us, ~0.2 us and ~0.26 us a blob on the card. The launch is bound
// instead by its chain: fr_evaluate a thread's 2 elements (2 dependent
// products), then 8 levels in the block and 3 in the cluster, one product
// and two barriers each, and the product by 1/n; fr_quotient 3 products
// for the block's root, 8 levels down and 2 products a thread -- ~15
// dependent products of ~1,300 cycles each; fr_quotient_in_domain the
// same, then 4 products a thread, the block's sum and the cluster's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

namespace cg = cooperative_groups;

using fr::Fr;

constexpr int kMaxThreads = 256;  // threads a blob's block; the tree's leaves
constexpr int kCluster = 8;  // blocks a blob from n = 2048 on
constexpr int kMaxLevels = 31;    // log2 n

inline int threads_for(int n) { return n < kMaxThreads ? n : kMaxThreads; }

inline int log2_of(int x) {  // x a power of two
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The block's sum of each thread's part, left in node[0].
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

// z = w_m, m in word 0 of the table's column L + 2, on the split of
// fr_quotient: a blob of n on G blocks of T threads, 2^lk elements a
// thread, block rank r owning the elements [r T 2^lk, (r + 1) T 2^lk).
template <int G>
__device__ void quotient_in_domain_blob(const int64_t* __restrict__ evals,
                                        const uint32_t* __restrict__ table,
                                        const uint32_t* __restrict__ roots,
                                        int64_t* __restrict__ out, int n, int lk) {
  // comp as in fr_quotient_kernel; held[l] = 2^l z^(2^l) / z, the product
  // of a chunk of 2^l that holds m without its zero factor
  __shared__ Fr comp[2 * kMaxThreads], node[kMaxThreads], pw[kMaxLevels], held[kMaxLevels];
  const int T = blockDim.x, t = threadIdx.x, lt = 31 - __clz(T), lg = 31 - __clz(G);
  const int rank = blockIdx.x % G, b = blockIdx.x / G;
  const int lb = lk + lt, L = lb + lg, W = L + 3;
  const uint32_t* tab = table + (size_t)b * fr::NL * W;
  const int m = (int)tab[L + 2];  // in [0, n): the wrapper checks
  const Fr z_inv = fr::load(tab, W, L + 1);
  if (t < L) {
    pw[t] = fr::load(tab, W, t);
    Fr h = fr::mul(pw[t], z_inv);
    for (int k = 0; k < t; ++k) h = fr::add(h, h);
    held[t] = h;
  }
  __syncthreads();
  // the product of the denominators of chunk g at size 2^l, m's left out
  auto denom = [&](int l, int g) {
    return g == (m >> l) ? held[l] : fr::sub(pw[l], fr::load(roots, n, g));
  };
  if (t == 0) {  // K times the denominators of the block's siblings above it
    Fr c = fr::load(tab, W, L);
    for (int l = lb; l < L; ++l) c = fr::mul(c, denom(l, (rank >> (l - lb)) ^ 1));
    comp[1] = c;
  }
  __syncthreads();
  for (int h = 1, level = lb - 1; h < T; h <<= 1, --level) {
    if (t < 2 * h) comp[2 * h + t] = fr::mul(comp[h + (t >> 1)], denom(level, rank * 2 * h + (t ^ 1)));
    __syncthreads();
  }
  const Fr mine = comp[T + t];
  const int64_t* e = evals + (size_t)b * 2 * fr::NL * n;
  int64_t* q = out + (size_t)b * 2 * fr::NL * n;
  const Fr y = load16(e, n, m);
  Fr part = fr::zero();  // sum of q_i w_i over this thread's elements
  for (int r = 0; r < (1 << lk); ++r) {
    const int i = ((rank * T + t) << lk) + r;
    Fr inv_i = mine;  // 1 / (z - w_i) for i != m
    for (int l = 0; l < lk; ++l) inv_i = fr::mul(inv_i, denom(l, (i >> l) ^ 1));
    const Fr qi = fr::mul(fr::sub(y, load16(e, n, i)), inv_i);  // 0 at m
    if (i != m) store16(q, n, i, qi);
    part = fr::add(part, fr::mul(qi, fr::load(roots, n, i)));
  }
  block_sum(part, node);
  if constexpr (G > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's sum is in its node[0]
    if (rank == 0 && t < G) node[t] = *cluster.map_shared_rank(node, t);
    cluster.sync();  // read: the other blocks may leave
    if (rank) return;
  }
  if (t == 0) {
    Fr s = node[0];
    for (int k = 1; k < G; ++k) s = fr::add(s, node[k]);
    store16(q, n, m, fr::neg(fr::mul(s, z_inv)));  // q_m = -(1/z) sum q_i w_i
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    fr_quotient_in_domain_kernel(const int64_t* __restrict__ evals,
                                 const uint32_t* __restrict__ table,
                                 const uint32_t* __restrict__ roots, int64_t* __restrict__ out,
                                 int n, int lk) {
  quotient_in_domain_blob<1>(evals, table, roots, out, n, lk);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
    fr_quotient_in_domain_cluster_kernel(const int64_t* __restrict__ evals,
                                         const uint32_t* __restrict__ table,
                                         const uint32_t* __restrict__ roots,
                                         int64_t* __restrict__ out, int n, int lk) {
  quotient_in_domain_blob<kCluster>(evals, table, roots, out, n, lk);
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

// fr_evaluate, fr_quotient and fr_quotient_in_domain: a blob of n (a
// power of two) on G blocks of T = min(n, 256) threads, G = 8 from n = 2048 on and 1 below,
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

extern "C" int lwkzg_fr_quotient_in_domain(const void* evals, const void* table,
                                           const void* roots, void* out, int B, int n,
                                           void* stream) {
  const Split s = split_for(n);
  const auto e = (const int64_t*)evals;
  const auto tab = (const uint32_t*)table, r = (const uint32_t*)roots;
  if (s.G == kCluster)
    fr_quotient_in_domain_cluster_kernel<<<B * s.G, s.T, 0, (cudaStream_t)stream>>>(
        e, tab, r, (int64_t*)out, n, s.lk);
  else
    fr_quotient_in_domain_kernel<<<B, s.T, 0, (cudaStream_t)stream>>>(e, tab, r, (int64_t*)out, n,
                                                                      s.lk);
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
