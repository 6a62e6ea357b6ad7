// K5: Montgomery Fq product (R = 2^400) of 8-bit digit columns.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_ntt_mul.py kern
//   (pallas_call in _mul_call, body mul_T): the int8-MXU NTT-CRT convolution
//   with REDC through transformed constants.
// Bound on this card: a column reads 2 x 51 digits and writes 64 (664 B,
//   0.208 ms at 2^20 columns and 3.35 TB/s). Its multiply-adds are one
//   full 12-limb CIOS product and 36 word products (the two reductions by
//   k q and the 2^-16 step), about 1.1 products' worth, under a fifth of
//   the time those bytes take: the bytes set its least time.
// Design: the TPU convolves digits on the MXU because it has no wide integer
//   multiply; the card has 32x32->64. A thread takes four adjacent columns
//   ([64, N] layout, N a multiple of 4: ntt_mul pads), so each digit row is
//   one 16-byte load a thread and a warp reads 512 adjacent bytes. Each
//   operand's digits (rows 0-50, each in [0, 319], as the reference reads
//   them) are packed into 13 words, x < 2^410, and brought below 3q by
//   x - k q, with k = floor(x / q) - 1 from a double-precision estimate (a
//   few words' products, not a field product).
//   The two then take one CIOS product of field.cuh (the PTX carry chains,
//   R' = 2^384: a b 2^-384 mod q, reduced, since a b < 9 q^2 < q R'), and one
//   16-bit Montgomery step, (v + m q) / 2^16 with m = -v mod 2^16, turns it
//   into a b 2^-400 mod q below 2q; one conditional subtraction makes it
//   canonical. The output is its canonical digits, rows 48-63 zero.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int L = Fq::L;
constexpr int W = L + 1;           // words of a packed column value
constexpr int ROWS_READ = 51;
constexpr int ROWS = 64;
constexpr int C = 4;               // adjacent columns a thread
constexpr double INV_Q = 0x1.30a8468662030p-377;   // 1 / q, rounded

// x (W words, x < 1.26 * 2^408, so x / q < 2^32) -> x - k q < 3q as L
// words. The top three words give x / q within 2^-18, so k =
// floor(estimate) - 1 is at most floor(x / q) and at least two below it.
ZK_DEV void reduce_packed(uint32_t* r, uint32_t* x) {
  const double xd = (double)x[W - 1] * 0x1p384 + (double)x[W - 2] * 0x1p352 +
                    (double)x[W - 3] * 0x1p320;
  const double kd = floor(xd * INV_Q) - 1.0;
  const uint32_t k = kd > 0.0 ? (uint32_t)kd : 0u;
  uint64_t carry = 0, borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint64_t prod = (uint64_t)k * (i < L ? Fq::p(i) : 0u) + carry;
    carry = prod >> 32;
    const uint64_t d = (uint64_t)x[i] - (uint32_t)prod - borrow;
    x[i] = (uint32_t)d;
    borrow = (d >> 32) & 1u;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = x[j];
}

// the C columns c0 .. c0 + C - 1 of one operand, reduced below 3q: word k
// of a column is its rows 4k .. 4k + 3, each digit below 2^9, shifted by
// 8 i, plus the carry out of word k - 1
ZK_DEV void load_columns(uint32_t (*r)[L], const int* __restrict__ cols,
                         long long n, long long c0) {
  uint32_t x[C][W];
  uint64_t carry[C];
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint32_t d[4][C];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * k + i;
      if (j >= ROWS_READ) {
#pragma unroll
        for (int c = 0; c < C; ++c) d[i][c] = 0;
      } else {
        const int4 v =
            __ldg(reinterpret_cast<const int4*>(cols + j * n + c0));
        d[i][0] = v.x;
        d[i][1] = v.y;
        d[i][2] = v.z;
        d[i][3] = v.w;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint64_t s = carry[c] + d[0][c] + ((uint64_t)d[1][c] << 8) +
                         ((uint64_t)d[2][c] << 16) +
                         ((uint64_t)d[3][c] << 24);
      x[c][k] = (uint32_t)s;
      carry[c] = s >> 32;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) reduce_packed(r[c], x[c]);
}

// v * 2^-16 mod q, canonical, for v < q: (v + m q) / 2^16 with
// m = -v mod 2^16 (q = 1 mod 2^32) is below 2q
ZK_DEV void div_2_16(uint32_t* v) {
  const uint32_t m = (0u - v[0]) & 0xffffu;
  uint32_t t[W];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    c += (uint64_t)v[j] + (uint64_t)m * Fq::p(j);
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[L] = (uint32_t)c;
#pragma unroll
  for (int j = 0; j < L; ++j) t[j] = (t[j] >> 16) | (t[j + 1] << 16);
  fq_sub_q(v, t);
}

// C adjacent columns a thread
__global__ void __launch_bounds__(128)
cols_mul(const int* __restrict__ a, const int* __restrict__ b,
         int* __restrict__ out, long long n) {
  const long long c0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * C;
  if (c0 >= n) return;
  uint32_t x[C][L], y[C][L];
  load_columns(x, a, n, c0);
  load_columns(y, b, n, c0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    fq_mul(x[c], x[c], y[c]);
    div_2_16(x[c]);
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    int d[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      d[c] = j < 4 * L ? (int)((x[c][j / 4] >> (8 * (j % 4))) & 0xffu) : 0;
    *reinterpret_cast<int4*>(out + j * n + c0) =
        make_int4(d[0], d[1], d[2], d[3]);
  }
}

}  // namespace

// out = a * b * 2^-400 mod q per column of the [64, n] int32 digit tensors,
// n a multiple of 4 (16-byte aligned rows); cudaErrorInvalidValue otherwise.
extern "C" int zk_fq_cols_mul(const void* a, const void* b, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  if (n % C != 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long t = n / C;
  cols_mul<<<(unsigned)((t + threads - 1) / threads), threads, 0,
             (cudaStream_t)stream>>>((const int*)a, (const int*)b, (int*)out,
                                     n);
  return (int)cudaGetLastError();
}
