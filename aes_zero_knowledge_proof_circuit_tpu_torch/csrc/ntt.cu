// K2: one radix-2 decimation-in-time butterfly stage over Fr, in place.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/pallas_field.py
//   _butterfly_kernel (pallas_call in _butterfly_call, reached through
//   pallas_butterfly), the stage body of ops/ntt_jax.py NTTEngine._core.
// Bound on this card: memory. A butterfly reads two elements and a twiddle
//   (96 B) and writes two (64 B) around one Montgomery product (~130
//   multiply-adds); a stage streams the whole [N, 8] array once.
// Design: one launch per stage, one thread per butterfly, in place on the
//   [N, 8] u32 array after a bit-reversal gather done by the caller. The
//   twiddle is read by stride from the single [N/2, 8] table of omega powers
//   (stage with half-width h uses omega^((N/2h) j)), as ntt_jax._core slices
//   it. Shared-memory multi-stage blocks are later work.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__global__ void ntt_stage(uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ tw, long long pairs,
                          long long half, long long tw_stride) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  long long g = t / half;
  long long j = t - g * half;
  long long i0 = g * 2 * half + j;
  long long i1 = i0 + half;
  uint32_t l[8], r[8], w[8];
  zk_load<8>(l, x + i0 * 8);
  zk_load<8>(r, x + i1 * 8);
  zk_load<8>(w, tw + j * tw_stride * 8);
  zk_mul<Fr>(r, r, w);
  uint32_t hi[8], lo[8];
  zk_add<Fr>(hi, l, r);
  zk_sub<Fr>(lo, l, r);
  zk_store<8>(x + i0 * 8, hi);
  zk_store<8>(x + i1 * 8, lo);
}

}  // namespace

// x: [n, 8] Fr Montgomery limbs (updated in place); tw: [n/2, 8] table of
// omega^j. half: half-width of this stage's butterfly groups.
extern "C" int zk_ntt_stage(void* x, const void* tw, long long n,
                            long long half, void* stream) {
  long long pairs = n / 2;
  if (pairs <= 0) return 0;
  long long tw_stride = n / (2 * half);
  const int threads = 256;
  long long blocks = (pairs + threads - 1) / threads;
  ntt_stage<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)x, (const uint32_t*)tw, pairs, half, tw_stride);
  return (int)cudaGetLastError();
}
