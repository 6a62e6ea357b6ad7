// Montgomery arithmetic over the BLS12-377 prime fields, shared by the
// kernels (fr_ops.cu, ntt.cu, fq_cols.cu; msm.cu and msm_u8.cu use the PTX
// Fq functions at the end).
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

// One element as L / 4 16-byte vectors (src and dst 16-byte aligned: rows
// of 32 or 48 bytes in a tensor the wrapper has checked).
template <int L>
ZK_DEV void zk_load_v(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

template <int L>
ZK_DEV void zk_store_v(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int q = 0; q < L / 4; ++q)
    reinterpret_cast<uint4*>(dst)[q] =
        make_uint4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
}

// a^e for the exponent's nbits >= 1 low bits (e as u32 limbs, low first),
// left to right square-and-multiply in one thread; 0^e = 0. Used where
// one thread's chain is the whole work (K1's pow, batch_inv's one
// inversion), so it takes the C product, the lower-latency one in a
// lone thread.
template <class F>
ZK_DEV void zk_pow(uint32_t* out, const uint32_t* a, const uint32_t* e,
                   int nbits) {
  constexpr int L = F::L;
  uint32_t acc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) acc[j] = a[j];
  for (int bit = nbits - 2; bit >= 0; --bit) {
    zk_mul<F>(acc, acc, acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) zk_mul<F>(acc, acc, a);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = acc[j];
}

// -- Fq with PTX carry chains (kernels K3 and K4) ------------------------------
//
// The same Montgomery-384 arithmetic as zk_mul<Fq> / zk_add<Fq> / zk_sub<Fq>
// above (fully reduced limbs, R = 2^384), written with mad.lo.cc / madc.hi.cc
// carry chains and the modulus as immediates: each row of the CIOS product is
// four chains (a * b_i low and high halves, m * q low and high halves). With
// a, b < q < 2^377 the running value stays below 2^410, so 13 limbs hold it
// and no chain loses a carry; one conditional subtraction ends the product.
// Each chain is one asm statement, so no instruction can come between the
// carry-out of one limb and the carry-in of the next.

// t[0..12] += a * bi (two carry chains: low then high halves)
ZK_DEV void fq_mac_row(uint32_t* t, const uint32_t* a, uint32_t bi) {
  asm("{\n\t"
      "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
      "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
      "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
      "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
      "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
      "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
      "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
      "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
      "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
      "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
      "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
      "addc.u32 %12, %12, 0;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(bi));
  asm("{\n\t"
      "mad.hi.cc.u32 %0, %12, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
      "madc.hi.cc.u32 %2, %14, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
      "madc.hi.cc.u32 %6, %18, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
      "madc.hi.cc.u32 %8, %20, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
      "madc.hi.cc.u32 %10, %22, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %23, %24, %11;\n\t"
      "}"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(bi));
}

// t[0..12] += m * q, m = -t[0] mod 2^32 (so t[0] becomes 0), then the
// shift by one limb: t = (t + m q) / 2^32
ZK_DEV void fq_reduce_row(uint32_t* t) {
  uint32_t m = 0u - t[0];   // t[0] * (-q^-1 mod 2^32); q = 1 mod 2^32
  asm("{\n\t"
      "mad.lo.cc.u32 %0, %13, 0x00000001, %0;\n\t"
      "madc.lo.cc.u32 %1, %13, 0x8508c000, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, 0x30000000, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, 0x170b5d44, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, 0xba094800, %4;\n\t"
      "madc.lo.cc.u32 %5, %13, 0x1ef3622f, %5;\n\t"
      "madc.lo.cc.u32 %6, %13, 0x00f5138f, %6;\n\t"
      "madc.lo.cc.u32 %7, %13, 0x1a22d9f3, %7;\n\t"
      "madc.lo.cc.u32 %8, %13, 0x6ca1493b, %8;\n\t"
      "madc.lo.cc.u32 %9, %13, 0xc63b05c0, %9;\n\t"
      "madc.lo.cc.u32 %10, %13, 0x17c510ea, %10;\n\t"
      "madc.lo.cc.u32 %11, %13, 0x01ae3a46, %11;\n\t"
      "addc.u32 %12, %12, 0;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(m));
  asm("{\n\t"
      "mad.hi.cc.u32 %0, %12, 0x00000001, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, 0x8508c000, %1;\n\t"
      "madc.hi.cc.u32 %2, %12, 0x30000000, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, 0x170b5d44, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, 0xba094800, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, 0x1ef3622f, %5;\n\t"
      "madc.hi.cc.u32 %6, %12, 0x00f5138f, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, 0x1a22d9f3, %7;\n\t"
      "madc.hi.cc.u32 %8, %12, 0x6ca1493b, %8;\n\t"
      "madc.hi.cc.u32 %9, %12, 0xc63b05c0, %9;\n\t"
      "madc.hi.cc.u32 %10, %12, 0x17c510ea, %10;\n\t"
      "madc.hi.cc.u32 %11, %12, 0x01ae3a46, %11;\n\t"
      "}"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(m));
#pragma unroll
  for (int j = 0; j < 12; ++j) t[j] = t[j + 1];
  t[12] = 0;
}

// out = x - q if x >= q, else x (x < 2q, 12 limbs)
ZK_DEV void fq_sub_q(uint32_t* out, const uint32_t* x) {
  uint32_t d[12], bw;
  asm("{\n\t"
      "sub.cc.u32 %0, %13, 0x00000001;\n\t"
      "subc.cc.u32 %1, %14, 0x8508c000;\n\t"
      "subc.cc.u32 %2, %15, 0x30000000;\n\t"
      "subc.cc.u32 %3, %16, 0x170b5d44;\n\t"
      "subc.cc.u32 %4, %17, 0xba094800;\n\t"
      "subc.cc.u32 %5, %18, 0x1ef3622f;\n\t"
      "subc.cc.u32 %6, %19, 0x00f5138f;\n\t"
      "subc.cc.u32 %7, %20, 0x1a22d9f3;\n\t"
      "subc.cc.u32 %8, %21, 0x6ca1493b;\n\t"
      "subc.cc.u32 %9, %22, 0xc63b05c0;\n\t"
      "subc.cc.u32 %10, %23, 0x17c510ea;\n\t"
      "subc.cc.u32 %11, %24, 0x01ae3a46;\n\t"
      "subc.u32 %12, 0, 0;\n\t"
      "}"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(bw)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]), "r"(x[7]), "r"(x[8]), "r"(x[9]), "r"(x[10]), "r"(x[11]));
#pragma unroll
  for (int j = 0; j < 12; ++j) out[j] = bw ? x[j] : d[j];
}

// a + b mod q
ZK_DEV void fq_add(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  uint32_t s[12];
  asm("{\n\t"
      "add.cc.u32 %0, %12, %24;\n\t"
      "addc.cc.u32 %1, %13, %25;\n\t"
      "addc.cc.u32 %2, %14, %26;\n\t"
      "addc.cc.u32 %3, %15, %27;\n\t"
      "addc.cc.u32 %4, %16, %28;\n\t"
      "addc.cc.u32 %5, %17, %29;\n\t"
      "addc.cc.u32 %6, %18, %30;\n\t"
      "addc.cc.u32 %7, %19, %31;\n\t"
      "addc.cc.u32 %8, %20, %32;\n\t"
      "addc.cc.u32 %9, %21, %33;\n\t"
      "addc.cc.u32 %10, %22, %34;\n\t"
      "addc.u32 %11, %23, %35;\n\t"
      "}"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(s[8]), "=r"(s[9]), "=r"(s[10]), "=r"(s[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  fq_sub_q(out, s);
}

// a - b mod q
ZK_DEV void fq_sub(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  uint32_t d[12], bw, qm[12];
  asm("{\n\t"
      "sub.cc.u32 %0, %13, %25;\n\t"
      "subc.cc.u32 %1, %14, %26;\n\t"
      "subc.cc.u32 %2, %15, %27;\n\t"
      "subc.cc.u32 %3, %16, %28;\n\t"
      "subc.cc.u32 %4, %17, %29;\n\t"
      "subc.cc.u32 %5, %18, %30;\n\t"
      "subc.cc.u32 %6, %19, %31;\n\t"
      "subc.cc.u32 %7, %20, %32;\n\t"
      "subc.cc.u32 %8, %21, %33;\n\t"
      "subc.cc.u32 %9, %22, %34;\n\t"
      "subc.cc.u32 %10, %23, %35;\n\t"
      "subc.cc.u32 %11, %24, %36;\n\t"
      "subc.u32 %12, 0, 0;\n\t"
      "}"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  // add q back on a borrow
  qm[0] = 0x00000001u & bw;
  qm[1] = 0x8508c000u & bw;
  qm[2] = 0x30000000u & bw;
  qm[3] = 0x170b5d44u & bw;
  qm[4] = 0xba094800u & bw;
  qm[5] = 0x1ef3622fu & bw;
  qm[6] = 0x00f5138fu & bw;
  qm[7] = 0x1a22d9f3u & bw;
  qm[8] = 0x6ca1493bu & bw;
  qm[9] = 0xc63b05c0u & bw;
  qm[10] = 0x17c510eau & bw;
  qm[11] = 0x01ae3a46u & bw;
  asm("{\n\t"
      "add.cc.u32 %0, %12, %24;\n\t"
      "addc.cc.u32 %1, %13, %25;\n\t"
      "addc.cc.u32 %2, %14, %26;\n\t"
      "addc.cc.u32 %3, %15, %27;\n\t"
      "addc.cc.u32 %4, %16, %28;\n\t"
      "addc.cc.u32 %5, %17, %29;\n\t"
      "addc.cc.u32 %6, %18, %30;\n\t"
      "addc.cc.u32 %7, %19, %31;\n\t"
      "addc.cc.u32 %8, %20, %32;\n\t"
      "addc.cc.u32 %9, %21, %33;\n\t"
      "addc.cc.u32 %10, %22, %34;\n\t"
      "addc.u32 %11, %23, %35;\n\t"
      "}"
      : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3]), "=r"(out[4]), "=r"(out[5]), "=r"(out[6]), "=r"(out[7]), "=r"(out[8]), "=r"(out[9]), "=r"(out[10]), "=r"(out[11])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]), "r"(d[6]), "r"(d[7]), "r"(d[8]), "r"(d[9]), "r"(d[10]), "r"(d[11]), "r"(qm[0]), "r"(qm[1]), "r"(qm[2]), "r"(qm[3]), "r"(qm[4]), "r"(qm[5]), "r"(qm[6]), "r"(qm[7]), "r"(qm[8]), "r"(qm[9]), "r"(qm[10]), "r"(qm[11]));
}

// a * b * 2^-384 mod q; out may alias a or b
ZK_DEV void fq_mul(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  uint32_t t[13];
#pragma unroll
  for (int j = 0; j < 13; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    fq_mac_row(t, a, b[i]);
    fq_reduce_row(t);
  }
  fq_sub_q(out, t);
}

// -- Inversion by the binary extended Euclidean algorithm -----------------
//
// R^3 mod q: fq_mul(x, ZK_FQ_R3) turns the plain inverse (a R)^-1 of a
// Montgomery element into the Montgomery form a^-1 R.
static __constant__ uint32_t ZK_FQ_R3[12] = {
    0x8815de20u, 0x581f532fu, 0xbe329585u, 0xe50f4148u,
    0x0449f513u, 0x2be8b118u, 0xc804a20eu, 0x6a2a9516u,
    0x13590cb9u, 0x3f725407u, 0xc0e7dda5u, 0x01065ab4u};

template <int L>
ZK_DEV bool zk_is_one_raw(const uint32_t* x) {
  uint32_t acc = x[0] ^ 1u;
#pragma unroll
  for (int j = 1; j < L; ++j) acc |= x[j];
  return acc == 0;
}

// x = (x + top 2^(32 L)) / 2
template <int L>
ZK_DEV void zk_shr1(uint32_t* x, uint32_t top) {
#pragma unroll
  for (int j = 0; j < L - 1; ++j) x[j] = (x[j] >> 1) | (x[j + 1] << 31);
  x[L - 1] = (x[L - 1] >> 1) | (top << 31);
}

// x / 2 mod p for x < p: x even ? x / 2 : (x + p) / 2
template <class F>
ZK_DEV void zk_halve(uint32_t* x) {
  constexpr int L = F::L;
  uint32_t top = 0;
  if (x[0] & 1u) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint64_t s = (uint64_t)x[j] + F::p(j) + c;
      x[j] = (uint32_t)s;
      c = s >> 32;
    }
    top = (uint32_t)c;
  }
  zk_shr1<L>(x, top);
}

template <int L>
ZK_DEV bool zk_geq(const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int j = L - 1; j >= 0; --j) {
    if (x[j] != y[j]) return x[j] > y[j];
  }
  return true;
}

// out = x - y for integers x >= y (no reduction)
template <int L>
ZK_DEV void zk_sub_raw(uint32_t* out, const uint32_t* x, const uint32_t* y) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint64_t v = (uint64_t)x[j] - y[j] - borrow;
    out[j] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
}

// out = a^-1 mod p for a plain integer a < p (0 gives 0). u, v start at a
// and p with x1 a = u and x2 a = v (mod p); each step halves an even u or v
// (and its x mod p) or takes the smaller of u and v from the larger, until
// one of them is 1: at most 2 log2(p) steps of shifts and subtractions on L
// limbs, with no products. It is meant for one thread whose lone chain of
// dependent operations sets the time, as the shared inversion of a batch
// does: a Fermat chain there is log2(p) dependent Montgomery products.
template <class F>
ZK_DEV void zk_inv_binary(uint32_t* out, const uint32_t* a) {
  constexpr int L = F::L;
  uint32_t u[L], v[L], x1[L], x2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    u[j] = a[j];
    v[j] = F::p(j);
    x1[j] = j == 0 ? 1u : 0u;
    x2[j] = 0;
  }
  if (zk_is_zero<F>(u)) {
    zk_store<L>(out, u);
    return;
  }
  while (!zk_is_one_raw<L>(u) && !zk_is_one_raw<L>(v)) {
    while (!(u[0] & 1u)) {
      zk_shr1<L>(u, 0);
      zk_halve<F>(x1);
    }
    while (!(v[0] & 1u)) {
      zk_shr1<L>(v, 0);
      zk_halve<F>(x2);
    }
    if (zk_geq<L>(u, v)) {
      zk_sub_raw<L>(u, u, v);
      zk_sub<F>(x1, x1, x2);
    } else {
      zk_sub_raw<L>(v, v, u);
      zk_sub<F>(x2, x2, x1);
    }
  }
  zk_store<L>(out, zk_is_one_raw<L>(u) ? x1 : x2);
}
