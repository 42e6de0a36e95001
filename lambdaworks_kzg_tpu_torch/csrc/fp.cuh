// Montgomery arithmetic in the BLS12-381 base field Fp for the G1 kernels
// (g1.cu): 12 x 32-bit limbs, little-endian, R = 2^384. A value in
// Montgomery form is the same integer as in the radix-2^16 limbs of the
// Python side (ops/limbs.py); only the radix differs. Every function
// returns a fully reduced value in [0, p), so results equal the plain
// PyTorch field (ops/field_ops.py) bit for bit.
//
// Replaces the in-kernel field of the TPU kernels,
// lambdaworks_kzg_tpu/ops/pallas_g1_v2.py::_KernelFp (radix-2^16
// schoolbook + REDC over [24, S, 128] vregs). Here one thread owns one
// lane and the product is CIOS over 32-bit words with 64-bit
// accumulators: 12 x 24 = 288 wide multiply-adds (plus 12 for the
// Montgomery factors) per multiplication. First, simple design: plain C++
// carries, no PTX carry chains.
#pragma once
#include <stdint.h>

namespace fp {

constexpr int NL = 12;

struct Fp {
  uint32_t v[NL];
};

// p, R mod p (Montgomery one) and -p^-1 mod 2^32
__constant__ Fp kP = {{0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                       0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                       0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau}};
__constant__ Fp kOne = {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                         0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                         0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u}};
constexpr uint32_t kPInv = 0xfffcfffdu;

// Limb k of lane m of an [NL, M] limbs-first array starts at base[k*M + m].
__device__ __forceinline__ Fp load(const uint32_t* __restrict__ base, int M,
                                   int m) {
  Fp a;
#pragma unroll
  for (int k = 0; k < NL; ++k) a.v[k] = base[(size_t)k * M + m];
  return a;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ base, int M,
                                      int m, const Fp& a) {
#pragma unroll
  for (int k = 0; k < NL; ++k) base[(size_t)k * M + m] = a.v[k];
}

__device__ __forceinline__ Fp zero() {
  Fp a;
#pragma unroll
  for (int k = 0; k < NL; ++k) a.v[k] = 0u;
  return a;
}

__device__ __forceinline__ Fp one() { return kOne; }

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < NL; ++k) acc |= a.v[k];
  return acc == 0u;
}

// d = a - b mod 2^384; returns 1 when a < b (a borrow out of the top)
__device__ __forceinline__ uint32_t sub_borrow(Fp& d, const Fp& a,
                                               const Fp& b) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    uint64_t t = (uint64_t)a.v[k] - (uint64_t)b.v[k] - (uint64_t)borrow;
    d.v[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  return borrow;
}

// a in [0, 2p) -> a mod p
__device__ __forceinline__ Fp reduce_once(const Fp& a) {
  Fp d;
  const Fp p = kP;
  uint32_t borrow = sub_borrow(d, a, p);
  Fp r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.v[k] = borrow ? a.v[k] : d.v[k];
  return r;
}

__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0u;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    c += (uint64_t)a.v[k] + (uint64_t)b.v[k];
    s.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once(s);  // a + b < 2p < 2^384: no carry out
}

__device__ __forceinline__ Fp dbl(const Fp& a) { return add(a, a); }

__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  Fp d;
  uint32_t borrow = sub_borrow(d, a, b);
  // a < b: add p back (mod 2^384)
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0u;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    c += (uint64_t)d.v[k] + (uint64_t)(kP.v[k] & mask);
    d.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return d;
}

// Montgomery product a * b * 2^-384 mod p (CIOS)
__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int k = 0; k < NL + 2; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0u;
    const uint64_t bi = b.v[i];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a.v[j] * bi + (uint64_t)t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += (uint64_t)t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);

    const uint64_t m = (uint32_t)(t[0] * kPInv);
    c = (m * (uint64_t)kP.v[0] + (uint64_t)t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += m * (uint64_t)kP.v[j] + (uint64_t)t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += (uint64_t)t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  // p < R/4, so the result is below 2p and t[NL] is 0
  Fp r;
#pragma unroll
  for (int k = 0; k < NL; ++k) r.v[k] = t[k];
  return reduce_once(r);
}

__device__ __forceinline__ Fp sqr(const Fp& a) { return mul(a, a); }

}  // namespace fp
