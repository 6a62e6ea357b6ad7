// Montgomery arithmetic over the BLS12-377 prime fields, shared by the three
// kernels (fr_ops.cu, ntt.cu, msm.cu).
//
// An element is L little-endian u32 limbs of a*R mod p, fully reduced below p:
//   Fr: L = 8,  R = 2^256  (p = r, 253 bits)
//   Fq: L = 12, R = 2^384  (p = q, 377 bits)
// The multiply is CIOS (coarsely integrated operand scanning) with 64-bit
// accumulators; both moduli leave spare top bits, so the running value never
// needs more than L + 1 words and one conditional subtraction ends every op.
#pragma once

#include <cstdint>

#define ZK_DEV __device__ __forceinline__

static __constant__ uint32_t ZK_FR_P[8] = {
    0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu,
    0x5c37b001u, 0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu};

static __constant__ uint32_t ZK_FQ_P[12] = {
    0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u,
    0xba094800u, 0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u,
    0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};

// R mod q: the Montgomery form of 1 in Fq (affine points enter with z = 1)
static __constant__ uint32_t ZK_FQ_ONE[12] = {
    0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u,
    0x8a7d3ff2u, 0x9f7db3a9u, 0x6e7c6305u, 0x7b4e97b7u,
    0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};

struct Fr {
  static constexpr int L = 8;
  static constexpr uint32_t N0 = 0xffffffffu;  // -p^-1 mod 2^32
  static ZK_DEV uint32_t p(int i) { return ZK_FR_P[i]; }
};

struct Fq {
  static constexpr int L = 12;
  static constexpr uint32_t N0 = 0xffffffffu;
  static ZK_DEV uint32_t p(int i) { return ZK_FQ_P[i]; }
};

// out = x - p if x >= p (x given as L limbs plus a carry word), else x
template <class F>
ZK_DEV void zk_reduce_once(uint32_t* out, const uint32_t* x, uint32_t top) {
  constexpr int L = F::L;
  uint32_t d[L];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t s = (uint64_t)x[j] - F::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  bool ge = top != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = ge ? d[j] : x[j];
}

template <class F>
ZK_DEV void zk_mul(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int L = F::L;
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::N0;
    s = (uint64_t)t[0] + (uint64_t)m * F::p(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * F::p(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }
  zk_reduce_once<F>(out, t, t[L]);
}

template <class F>
ZK_DEV void zk_add(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int L = F::L;
  uint32_t s[L];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  zk_reduce_once<F>(out, s, (uint32_t)c);
}

template <class F>
ZK_DEV void zk_sub(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  constexpr int L = F::L;
  uint32_t d[L];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
  // a < b: add p back (the sum wraps past 2^(32L) exactly once)
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)d[j] + (F::p(j) & mask) + c;
    out[j] = (uint32_t)v;
    c = v >> 32;
  }
}

template <class F>
ZK_DEV bool zk_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < F::L; ++j) acc |= a[j];
  return acc == 0;
}

template <int L>
ZK_DEV void zk_load(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = src[j];
}

template <int L>
ZK_DEV void zk_store(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = src[j];
}
