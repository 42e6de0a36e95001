// The Fr polynomial kernels for Hopper (sm_90a), on the scalar field of
// fr.cuh: fr_evaluate, fr_quotient, fr_quotient_in_domain, and the
// elementwise fr_to_mont and fr_check.
//
// They replace the three programs the JAX package jits once per domain
// size, lambdaworks_kzg_tpu/ops/fr_poly.py:
//   fr_evaluate           <- FrDomain._eval_kernel (:66)
//       y = (z^n - 1) / n * sum_i e_i w_i / (z - w_i)
//   fr_quotient           <- FrDomain._quotient_kernel (:82)
//       q_i = (e_i - y) / (w_i - z), out of Montgomery form
//   fr_quotient_in_domain <- FrDomain._quotient_in_domain_kernel (:94)
//       z = w_m: q_i as above for i != m, and
//       q_m = sum_{i != m} (e_i - y) w_i / (z (z - w_i)), y = e_m
// and fr_to_mont the XLA FR.to_mont (lambdaworks_kzg_tpu/ops/field_ops.py
// :97) that puts a batch's evaluations into Montgomery form before them.
// fr_check returns the field's product, square, sum, difference,
// negation, inverse and both conversions, to hold fr.cuh against the
// plain field (ops/field_ops.py FR) on the card.
//
// Layout: limbs-first u32 arrays, Montgomery form with R = 2^256: the
// evaluations [B, 8, n] (limb k of blob b's element i at (b 8 + k) n + i),
// the roots w_i in bit-reversed order [8, n], one value per blob [B, 8, 1]
// (z, z^n - 1, y, 1/z) and 1/n [8, 1]; the in-domain index m as int32[B].
// The quotients come out PLAIN [B, 8, n], the form the fixed-base MSM
// takes its digits from.
//
// Design: one block of T = min(n, 256) threads per blob, thread t owning
// the elements i = t + k T (k < n / T; neighbouring threads on
// neighbouring addresses). The denominators are inverted by Montgomery's
// trick on two levels: each thread runs the prefix products of its own
// elements (kept in global scratch, the quotient's output for the
// quotients), the block builds a product tree of the T partial products
// in shared memory, one thread inverts the root by Fermat (fr::inv), the
// tree walks back down to each thread's partial inverse, and each thread
// walks its elements back, one inverse each. Then the terms, and for the
// evaluation and q_m a block sum in shared memory. Every result is
// canonical, so neither the tree's order nor the sum's needs to follow
// JAX's: the outputs equal the plain PyTorch versions
// (ops/fr_poly.py) bit for bit. At a z inside the domain fr_evaluate's
// root product is 0, its inverse 0, and the launch ends with a
// meaningless y, which the caller replaces with the stored element;
// fr_quotient_in_domain sets the zero denominator at m to one for the
// inversion and its inverse to zero, as ops/fr_poly.py does.
//
// What bounds it: a blob of n = 4096 moves 256 KB (evaluations in,
// quotient out; the roots are shared) and needs ~6 n products (one
// forward, two back, two or three for the terms) and one inversion, ~7 M
// IMADs: the card's bound is ~0.4 us a blob, by operations. The launch is
// bound instead by its chains: one thread's Fermat inversion (252
// squarings and 73 products, dependent) and each thread's n / T = 16
// elements of dependent products on either side of it, on one SM per
// blob. A later design can spread a blob over more blocks and a
// cooperative field (ROADMAP queue B item 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

using fr::Fr;

constexpr int kMaxThreads = 256;  // threads a blob's block; the tree's leaves

inline int threads_for(int n) { return n < kMaxThreads ? n : kMaxThreads; }

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

__global__ void __launch_bounds__(kMaxThreads)
    fr_evaluate_kernel(const uint32_t* __restrict__ evals, const uint32_t* __restrict__ z,
                       const uint32_t* __restrict__ zn1, const uint32_t* __restrict__ roots,
                       const uint32_t* __restrict__ n_inv, uint32_t* scratch,
                       uint32_t* __restrict__ out, int n) {
  __shared__ Fr node[2 * kMaxThreads];
  __shared__ Fr inv[2 * kMaxThreads];
  const int b = blockIdx.x;
  const uint32_t* e = evals + (size_t)b * fr::NL * n;
  const Fr zb = fr::load(z + b * fr::NL, 1, 0);
  Fr part = fr::zero();
  batch_inverse(
      n, scratch + (size_t)b * fr::NL * n, node, inv,
      [&](int i) { return fr::sub(zb, fr::load(roots, n, i)); },
      [&](int i, const Fr& inv_i) {
        const Fr term = fr::mul(fr::mul(fr::load(e, n, i), fr::load(roots, n, i)), inv_i);
        part = fr::add(part, term);
      });
  block_sum(part, node);
  if (threadIdx.x == 0) {
    const Fr y = fr::mul(fr::mul(node[0], fr::load(zn1 + b * fr::NL, 1, 0)), fr::load(n_inv, 1, 0));
    fr::store(out + b * fr::NL, 1, 0, y);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    fr_quotient_kernel(const uint32_t* __restrict__ evals, const uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ z, const uint32_t* __restrict__ roots,
                       uint32_t* out, int n) {
  __shared__ Fr node[2 * kMaxThreads];
  __shared__ Fr inv[2 * kMaxThreads];
  const int b = blockIdx.x;
  const uint32_t* e = evals + (size_t)b * fr::NL * n;
  uint32_t* q = out + (size_t)b * fr::NL * n;  // also the prefix products
  const Fr yb = fr::load(y + b * fr::NL, 1, 0);
  const Fr zb = fr::load(z + b * fr::NL, 1, 0);
  batch_inverse(
      n, q, node, inv, [&](int i) { return fr::sub(fr::load(roots, n, i), zb); },
      [&](int i, const Fr& inv_i) {
        fr::store(q, n, i, fr::from_mont(fr::mul(fr::sub(fr::load(e, n, i), yb), inv_i)));
      });
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

}  // namespace

// Launchers: raw device pointers, the blob count B (one block each) and
// the domain size n (a power of two), or the lane count, and a
// cudaStream_t. Each returns cudaGetLastError() after its launch (0 on
// success).

extern "C" int lwkzg_fr_evaluate(const void* evals, const void* z, const void* zn1,
                                 const void* roots, const void* n_inv, void* scratch, void* out,
                                 int B, int n, void* stream) {
  fr_evaluate_kernel<<<B, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)evals, (const uint32_t*)z, (const uint32_t*)zn1, (const uint32_t*)roots,
      (const uint32_t*)n_inv, (uint32_t*)scratch, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_fr_quotient(const void* evals, const void* y, const void* z,
                                 const void* roots, void* out, int B, int n, void* stream) {
  fr_quotient_kernel<<<B, threads_for(n), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)evals, (const uint32_t*)y, (const uint32_t*)z, (const uint32_t*)roots,
      (uint32_t*)out, n);
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
