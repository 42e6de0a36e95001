// The pairing check's kernels for Hopper (sm_90a): pairing_miller_loop and
// pairing_final_exp, the device pairing tier of verification.
//
// The JAX package has no Pallas kernel here: its pairing is XLA
// (lambdaworks_kzg_tpu/ops/pairing_ops.py), lax.scans over the bits of the
// BLS parameter. These two kernels replace
//   pairing_miller_loop <- g1_to_affine (:267) + g2_to_affine (:277) +
//                          miller_loop (:176): per pair, the affine points,
//                          the validity mask, the Miller loop over the bits
//                          of |x| below its top bit in homogeneous
//                          projective twist coordinates with sparse lines
//                          (_dbl_step :93, _add_step :126), invalid pairs
//                          set to one, and the conjugation for x < 0;
//   pairing_final_exp   <- lane_product (:202) + final_exp_cubed (:243) +
//                          tower_ops.fp12_eq_one (:228): the product of the
//                          pairs' values, FE(f)^3 by the x-chain, and its
//                          == 1.
// Their plain versions are ops/pairing_ops.py miller_loop_jac and
// final_exp_check. Every field value is fully reduced, and the Miller
// loop's steps evaluate the plain version's polynomials, so each output
// equals the plain version's limb for limb.
//
// Layout: limbs-first u32 arrays in Montgomery form (g1.cu): G1 Jacobian
// [3, 12, B]; G2 Jacobian [3, 2, 12, B] (coordinate, Fp2 component, limb,
// lane); Miller values [12, 12, B], twelve Fp coefficients in the plain
// tower's flatten12 order; the Frobenius constants gamma_k =
// xi^(k (p - 1) / 6) as [6, 2, 12]; the bits of |x| and |x - 1| as
// 64-bit arguments; the level program (levels.cuh) from the wrapper.
//
// What bounds them: the chain of dependent field operations. The work is
// small (the products of a check as integer multiply-adds take under 1 us
// at the card's rate), but a Miller loop is 63 doubling steps and 5
// addition steps, and the final exponentiation five 64-bit powers of
// squarings, each step waiting on the one before: on one thread a pair
// walks ~9,800 dependent fp::mul, and the final exponentiation ~8,100
// (18.9 and 16.6 ms at B = 2 on an H100). So each step runs its
// independent Fp products side by side: one block of 224
// threads per pair (grid B) for the Miller loop, one block for the final
// exponentiation, the values and the program in shared memory, and each
// step a short sequence of levels of up to 56 products on fp_coop.cuh's
// groups of four threads, with the sums between levels one value per
// thread (levels.cuh). A doubling step (f^2, the tangent and 2T, the
// sparse line product) is 3 levels, an addition step 4, a cyclotomic
// square 1 (30 products of its own words, so no sums come before it), an
// Fp12 product 1 of 54. The inversions (the affine points' two, side by
// side, and the final exponentiation's one) run a binary extended Euclid
// on one thread. ops/pairing_levels.py schedules the levels and counts
// them: 214 levels and 283 linear waves for the Miller loop, 361 and 394
// for the final exponentiation at B = 2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace {

// the subroutines of the programs (ops/pairing_levels.py MILLER_SUBS, FE_SUBS)
enum MillerSub : int { kAffine = 0, kDbl = 1, kAdd = 2, kFinal = 3 };
enum FeSub : int { kMulAcc = 0, kEasy, kCyc0, kCyc, kMulB, kG1, kG2, kG3, kG5 };
// io slots: Miller: 9 inputs, one, 12 outputs; final exponentiation: acc
// (12), fin (12), gamma (12), one, out (12)
constexpr int kMillerOne = 9, kMillerOut = 10;
constexpr int kFeAcc = 0, kFeFin = 12, kFeGamma = 24, kFeOne = 36, kFeOut = 37;
constexpr int kCoef = 12 * fp::NL;  // the words of one Fp12 value

__global__ void __launch_bounds__(lv::kThreads, 1)
    pairing_miller_loop_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                               uint32_t* __restrict__ out, int B, unsigned long long x_abs,
                               const int32_t* __restrict__ prog, int prog_words) {
  using lv::S;
  const int m = blockIdx.x;
  const size_t blk = (size_t)fp::NL * B;  // one Fp [12, B] block
  // a member at infinity writes one: every thread reads the same Z's, so
  // the branch is the block's
  const bool inf = fp::is_zero(fp::load(p + 2 * blk, B, m)) ||
                   (fp::is_zero(fp::load(q + 4 * blk, B, m)) &&
                    fp::is_zero(fp::load(q + 5 * blk, B, m)));
  if (inf) {
    for (int t = threadIdx.x; t < kCoef; t += blockDim.x)
      out[(size_t)t * B + m] = t < fp::NL ? fp::kOne.v[t] : 0u;
    return;
  }
  const int po = lv::load_program(prog, prog_words);
  __syncthreads();
  for (int t = threadIdx.x; t < 9 * fp::NL; t += blockDim.x) {
    const int i = t / fp::NL, k = t % fp::NL;
    const uint32_t* src = i < 3 ? p + i * blk : q + (i - 3) * blk;
    S[lv::io(po, i) * lv::kWords + k] = src[(size_t)k * B + m];
  }
  if (threadIdx.x < fp::NL)
    S[lv::io(po, kMillerOne) * lv::kWords + threadIdx.x] = fp::kOne.v[threadIdx.x];
  __syncthreads();
  lv::run(po, kAffine);
  const int top = 63 - __clzll(x_abs);
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    lv::run(po, kDbl);
    if ((x_abs >> i) & 1ull) lv::run(po, kAdd);
  }
  lv::run(po, kFinal);
  for (int t = threadIdx.x; t < kCoef; t += blockDim.x)
    out[(size_t)t * B + m] = S[lv::io(po, kMillerOut + t / fp::NL) * lv::kWords + t % fp::NL];
}

// r = base^e for base in the cyclotomic subgroup (BASE and R of the
// program): Granger-Scott squarings from the top bit, a product by BASE at
// each set bit below it; the first squaring reads BASE
__device__ __forceinline__ void pow_abs(int po, unsigned long long e) {
  const int top = 63 - __clzll(e);
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    lv::run(po, i == top - 1 ? kCyc0 : kCyc);
    if ((e >> i) & 1ull) lv::run(po, kMulB);
  }
}

__global__ void __launch_bounds__(lv::kThreads, 1)
    pairing_final_exp_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ gamma,
                             uint32_t* __restrict__ out, uint8_t* __restrict__ ok, int B,
                             unsigned long long x_abs, unsigned long long xm1_abs,
                             const int32_t* __restrict__ prog, int prog_words) {
  using lv::S;
  if (blockIdx.x != 0) return;
  const int t0 = threadIdx.x;
  const int po = lv::load_program(prog, prog_words);
  __syncthreads();
  for (int t = t0; t < kCoef; t += blockDim.x) {
    S[lv::io(po, kFeAcc + t / fp::NL) * lv::kWords + t % fp::NL] = f[(size_t)t * B];
    S[lv::io(po, kFeGamma + t / fp::NL) * lv::kWords + t % fp::NL] = gamma[t];
  }
  if (t0 < fp::NL) S[lv::io(po, kFeOne) * lv::kWords + t0] = fp::kOne.v[t0];
  __syncthreads();
  // the product of the pairs' values
#pragma unroll 1
  for (int i = 1; i < B; ++i) {
    for (int t = t0; t < kCoef; t += blockDim.x)
      S[lv::io(po, kFeFin + t / fp::NL) * lv::kWords + t % fp::NL] = f[(size_t)t * B + i];
    __syncthreads();
    lv::run(po, kMulAcc);
  }
  // the easy part: m = f^((p^6 - 1)(p^2 + 1)), cyclotomic
  lv::run(po, kEasy);
  // the hard part, cubed: m^((x - 1)^2 (x + p)(x^2 + p^2 - 1) + 3)
  pow_abs(po, xm1_abs);
  lv::run(po, kG1);  // BASE = conj(R)
  pow_abs(po, xm1_abs);
  lv::run(po, kG2);  // BM = BASE = m^((x - 1)^2)
  pow_abs(po, x_abs);
  lv::run(po, kG3);  // C = BASE = bm^(x + p)
  pow_abs(po, x_abs);
  lv::run(po, kG1);
  pow_abs(po, x_abs);
  lv::run(po, kG5);  // c^(x^2 + p^2 - 1) m^3
  for (int t = t0; t < kCoef; t += blockDim.x)
    out[t] = S[lv::io(po, kFeOut + t / fp::NL) * lv::kWords + t % fp::NL];
  if (t0 == 0) {
    uint32_t d = 0u;
    for (int t = 0; t < kCoef; ++t)
      d |= S[lv::io(po, kFeOut + t / fp::NL) * lv::kWords + t % fp::NL] ^
           (t < fp::NL ? fp::kOne.v[t] : 0u);
    *ok = d == 0u ? 1 : 0;
  }
}

}  // namespace

// a kernel's dynamic shared memory (the slots and the program) above the
// default 48 KB, set once per device when the wrapper first copies the
// program there; which: 0 the Miller loop, 1 the final exponentiation
extern "C" int lwkzg_pairing_smem(int which, int smem, void* stream) {
  (void)stream;
  if (smem <= 48 * 1024) return 0;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  return (int)(which == 0 ? cudaFuncSetAttribute(pairing_miller_loop_kernel, a, smem)
                          : cudaFuncSetAttribute(pairing_final_exp_kernel, a, smem));
}

extern "C" int lwkzg_pairing_miller_loop(const void* p, const void* q, void* out, int B,
                                         unsigned long long x_abs, const void* prog,
                                         int prog_words, int smem, void* stream) {
  pairing_miller_loop_kernel<<<B, lv::kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, B, x_abs, (const int32_t*)prog,
      prog_words);
  return (int)cudaGetLastError();
}

extern "C" int lwkzg_pairing_final_exp(const void* f, const void* gamma, void* out, void* ok,
                                       int B, unsigned long long x_abs,
                                       unsigned long long xm1_abs, const void* prog,
                                       int prog_words, int smem, void* stream) {
  pairing_final_exp_kernel<<<1, lv::kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (const uint32_t*)gamma, (uint32_t*)out, (uint8_t*)ok, B, x_abs, xm1_abs,
      (const int32_t*)prog, prog_words);
  return (int)cudaGetLastError();
}
