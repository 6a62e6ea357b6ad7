// K1: elementwise Montgomery mul, add and sub over Fr (and Fq).
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/pallas_field.py
//   _mul_kernel (pallas_call in _mul_call, reached through pallas_mul), and on
//   the TPU its XLA twin F32Ops.mul (ops/field_f32.py), which every Fr product
//   of the prover and the indexer runs.
// Bound on this card: memory. One Fr product reads 64 B and writes 32 B
//   against ~130 32-bit multiply-adds, far below the card's ops-per-byte
//   balance, so the kernel runs at the speed of the loads and stores.
// Design: one thread per element, the limbs of an element held in registers,
//   CIOS with 64-bit products (the TPU's f32-digit convolution and Toeplitz
//   REDC matmuls are not needed: the card multiplies 32x32->64 natively).
//   An operand with a row stride of 0 is a broadcast scalar, so a product by
//   a constant reads the constant once per thread from cache instead of a
//   materialized [N, L] copy.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum Op { kMul = 0, kAdd = 1, kSub = 2 };

template <class F, int OP>
__global__ void field_binop(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ out, long long n,
                            int a_stride, int b_stride) {
  constexpr int L = F::L;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], y[L], r[L];
  zk_load<L>(x, a + i * a_stride);
  zk_load<L>(y, b + i * b_stride);
  if (OP == kMul) {
    zk_mul<F>(r, x, y);
  } else if (OP == kAdd) {
    zk_add<F>(r, x, y);
  } else {
    zk_sub<F>(r, x, y);
  }
  zk_store<L>(out + i * L, r);
}

template <class F, int OP>
int launch(const void* a, const void* b, void* out, long long n, int a_bcast,
           int b_bcast, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  field_binop<F, OP><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n,
      a_bcast ? 0 : F::L, b_bcast ? 0 : F::L);
  return (int)cudaGetLastError();
}

template <int OP>
int dispatch(const void* a, const void* b, void* out, long long n, int field,
             int a_bcast, int b_bcast, void* stream) {
  if (field == 0) return launch<Fr, OP>(a, b, out, n, a_bcast, b_bcast, stream);
  if (field == 1) return launch<Fq, OP>(a, b, out, n, a_bcast, b_bcast, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// field: 0 = Fr (8 limbs), 1 = Fq (12 limbs). *_bcast: the operand is one
// row read by every element. Returns cudaGetLastError() after the launch.
extern "C" int zk_field_mul(const void* a, const void* b, void* out,
                            long long n, int field, int a_bcast, int b_bcast,
                            void* stream) {
  return dispatch<kMul>(a, b, out, n, field, a_bcast, b_bcast, stream);
}

extern "C" int zk_field_add(const void* a, const void* b, void* out,
                            long long n, int field, int a_bcast, int b_bcast,
                            void* stream) {
  return dispatch<kAdd>(a, b, out, n, field, a_bcast, b_bcast, stream);
}

extern "C" int zk_field_sub(const void* a, const void* b, void* out,
                            long long n, int field, int a_bcast, int b_bcast,
                            void* stream) {
  return dispatch<kSub>(a, b, out, n, field, a_bcast, b_bcast, stream);
}
