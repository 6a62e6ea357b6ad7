// K5: Montgomery Fq product (R = 2^400) of 8-bit digit columns.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_ntt_mul.py kern
//   (pallas_call in _mul_call, body mul_T): the int8-MXU NTT-CRT convolution
//   with REDC through transformed constants.
// Bound on this card: memory. A column reads 2 x 51 digits and writes 64
//   (664 B) against six 12-limb CIOS products (a few thousand 32-bit
//   multiply-adds), well below the card's ratio of operations to bytes.
// Design: the TPU convolves digits on the MXU because it has no wide integer
//   multiply; the card has 32x32->64, so the product is the CIOS of
//   field.cuh over 12 u32 limbs (R' = 2^384). One thread per column: a warp
//   reading digit row j reads 32 adjacent words ([64, N] layout). Each
//   operand's digits (rows 0-50, each in [0, 319], as the reference reads
//   them) are packed into 13 limbs, x = lo + hi 2^384, and mapped to
//   x R' mod q = mont(lo, R'^2) + mont(hi, R'^3); CIOS accepts lo < 2^384
//   against a reduced constant. The product of the two is a b R', and one
//   more product by the integer 2^-400 mod q gives a b 2^-400 mod q, fully
//   reduced. The output is its canonical digits, rows 48-63 zero.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int L = Fq::L;
constexpr int ROWS_READ = 51;
constexpr int ROWS = 64;

// digits of column c (rows 0-50) -> value * 2^384 mod q
ZK_DEV void to_mont384(uint32_t* out, const int* __restrict__ cols,
                       long long n, long long c, const uint32_t* r2,
                       const uint32_t* r3) {
  uint64_t w[L + 2];
#pragma unroll
  for (int k = 0; k < L + 2; ++k) w[k] = 0;
#pragma unroll
  for (int j = 0; j < ROWS_READ; ++j) {
    w[j / 4] += (uint64_t)(uint32_t)cols[j * n + c] << (8 * (j % 4));
  }
  uint32_t lo[L], hi[L], t[L];
#pragma unroll
  for (int k = 0; k < L + 1; ++k) {
    w[k + 1] += w[k] >> 32;
    w[k] &= 0xffffffffu;
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    lo[k] = (uint32_t)w[k];
    hi[k] = 0;
  }
  hi[0] = (uint32_t)w[L];
  zk_mul<Fq>(out, lo, r2);
  zk_mul<Fq>(t, hi, r3);
  zk_add<Fq>(out, out, t);
}

// consts: [3, 12] limbs of 2^768 mod q, 2^1152 mod q and 2^-400 mod q
__global__ void cols_mul(const int* __restrict__ a, const int* __restrict__ b,
                         const uint32_t* __restrict__ consts,
                         int* __restrict__ out, long long n) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  uint32_t r2[L], r3[L], inv[L], x[L], y[L];
  zk_load<L>(r2, consts);
  zk_load<L>(r3, consts + L);
  zk_load<L>(inv, consts + 2 * L);
  to_mont384(x, a, n, c, r2, r3);
  to_mont384(y, b, n, c, r2, r3);
  zk_mul<Fq>(x, x, y);
  zk_mul<Fq>(x, x, inv);
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    out[j * n + c] = j < 4 * L ? (int)((x[j / 4] >> (8 * (j % 4))) & 0xffu) : 0;
  }
}

}  // namespace

// out = a * b * 2^-400 mod q per column of the [64, n] int32 digit tensors.
extern "C" int zk_fq_cols_mul(const void* a, const void* b,
                              const void* consts, void* out, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  cols_mul<<<(unsigned)((n + threads - 1) / threads), threads, 0,
              (cudaStream_t)stream>>>((const int*)a, (const int*)b,
                                      (const uint32_t*)consts, (int*)out, n);
  return (int)cudaGetLastError();
}
