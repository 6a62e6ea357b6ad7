// K1: elementwise Montgomery mul, add and sub over Fr (and Fq); powers and
// batch inversion.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/pallas_field.py
//   _mul_kernel (pallas_call in _mul_call, reached through pallas_mul), and on
//   the TPU its XLA twin F32Ops (ops/field_f32.py): mul, which every Fr
//   product of the prover and the indexer runs, and pow_int_loop, inv and
//   batch_inv, which XLA traces into one program each.
// Bound on this card: memory for the elementwise ops. One Fr product reads
//   64 B and writes 32 B against ~130 32-bit multiply-adds, far below the
//   card's ops-per-byte balance. The batch inversion moves about 5 rows a
//   row (read twice, prefix written and read, result written) around 3
//   products a row, plus one exponentiation whose dependent chain of ~380
//   products in one thread is latency, not work.
// Design: elementwise ops run one thread per element, each row loaded and
//   stored as 16-byte vectors, CIOS with 64-bit products on the limbs in
//   registers. An operand with a row stride of 0 is a broadcast scalar, read
//   once per thread from cache. pow runs the exponent's bits in the kernel,
//   one thread per row. batch_inv is Montgomery's trick in three launches:
//   (1) each thread keeps the running product of its chunk of kChunk rows
//   (zeros skipped), stores it row by row and a block scans its chunk totals
//   in shared memory to its block total; (2) one block inverts the block
//   totals: runs of them per thread, a scan of the run totals, ONE Fermat
//   exponentiation, and a sweep back; (3) each block rescans its chunk
//   totals to get each chunk's inverse and each thread sweeps its chunk
//   backwards, writing a^-1 = (inverse of the running product) * (the
//   product before it). Zeros map to zero and leave their chunk's other
//   rows untouched.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum Op { kMul = 0, kAdd = 1, kSub = 2 };

// batch_inv's geometry: ops/field.py INV_CHUNK and INV_BLOCK hold the same
// numbers, to size the scratch rows
constexpr int kChunk = 8;
constexpr int kBlock = 256;
constexpr int kTotThreads = 256;

template <class F, int OP>
__global__ void field_binop(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ out, long long n,
                            int a_stride, int b_stride) {
  constexpr int L = F::L;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], y[L], r[L];
  zk_load_v<L>(x, a + i * a_stride);
  zk_load_v<L>(y, b + i * b_stride);
  if (OP == kMul) {
    zk_mul<F>(r, x, y);
  } else if (OP == kAdd) {
    zk_add<F>(r, x, y);
  } else {
    zk_sub<F>(r, x, y);
  }
  zk_store_v<L>(out + i * L, r);
}

template <class F>
__global__ void field_pow(const uint32_t* __restrict__ a,
                          uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ e, int nbits,
                          long long n) {
  constexpr int L = F::L;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L];
  zk_load_v<L>(x, a + i * L);
  zk_pow<F>(x, x, e, nbits);
  zk_store_v<L>(out + i * L, x);
}

// Inclusive running product of the B rows x[0..B) in shared memory, in
// place (Hillis-Steele), from the front or (reverse) from the back. Every
// thread of the block calls it; thread k owns row k.
template <class F>
ZK_DEV void block_scan(uint32_t* x, int B, bool reverse) {
  constexpr int L = F::L;
  const int k = threadIdx.x;
  for (int d = 1; d < B; d <<= 1) {
    uint32_t v[L];
    int other = reverse ? k + d : k - d;
    bool take = reverse ? other < B : other >= 0;
    if (take) zk_mul<F>(v, x + other * L, x + k * L);
    __syncthreads();
    if (take) zk_store<L>(x + k * L, v);
    __syncthreads();
  }
}

// x^-1 for row k of B from the inclusive prefix P and suffix S of the
// rows and the inverse of their product: inv * P[k-1] * S[k+1].
template <class F>
ZK_DEV void row_inverse(uint32_t* out, const uint32_t* inv,
                        const uint32_t* P, const uint32_t* S, int B) {
  constexpr int L = F::L;
  const int k = threadIdx.x;
  zk_store<L>(out, inv);
  if (k > 0) zk_mul<F>(out, out, P + (k - 1) * L);
  if (k + 1 < B) zk_mul<F>(out, out, S + (k + 1) * L);
}

// (1) chunk prefixes into out, chunk totals into ctot, block totals into btot
template <class F>
__global__ void __launch_bounds__(kBlock)
inv_chunk_prefix(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ ctot, uint32_t* __restrict__ btot,
                 const uint32_t* __restrict__ one, long long n) {
  constexpr int L = F::L;
  __shared__ uint32_t X[kBlock * L];
  const long long chunk = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long start = chunk * kChunk;
  const long long stop = start + kChunk < n ? start + kChunk : n;
  uint32_t acc[L], x[L];
  zk_load_v<L>(acc, one);
  for (long long i = start; i < stop; ++i) {
    zk_load_v<L>(x, a + i * L);
    if (!zk_is_zero<F>(x)) zk_mul<F>(acc, acc, x);
    zk_store_v<L>(out + i * L, acc);
  }
  zk_store_v<L>(ctot + chunk * L, acc);
  zk_store<L>(X + threadIdx.x * L, acc);
  __syncthreads();
  block_scan<F>(X, kBlock, false);
  if (threadIdx.x == kBlock - 1)
    zk_store_v<L>(btot + (long long)blockIdx.x * L, X + threadIdx.x * L);
}

// (2) one block: btot[i] <- btot[i]^-1 for the nb block totals (never zero),
// bpre as scratch for the runs' running products
template <class F>
__global__ void __launch_bounds__(kTotThreads)
inv_totals(uint32_t* __restrict__ btot, uint32_t* __restrict__ bpre,
           const uint32_t* __restrict__ one, const uint32_t* __restrict__ e,
           int nbits, long long nb) {
  constexpr int L = F::L;
  __shared__ uint32_t P[kTotThreads * L], S[kTotThreads * L], G[L];
  const int k = threadIdx.x;
  const long long run = (nb + kTotThreads - 1) / kTotThreads;
  const long long start = k * run < nb ? k * run : nb;
  const long long stop = start + run < nb ? start + run : nb;
  uint32_t acc[L], x[L];
  zk_load_v<L>(acc, one);
  for (long long i = start; i < stop; ++i) {
    zk_load_v<L>(x, btot + i * L);
    zk_mul<F>(acc, acc, x);
    zk_store_v<L>(bpre + i * L, acc);
  }
  zk_store<L>(P + k * L, acc);
  zk_store<L>(S + k * L, acc);
  __syncthreads();
  block_scan<F>(P, kTotThreads, false);
  block_scan<F>(S, kTotThreads, true);
  if (k == 0) zk_pow<F>(G, P + (kTotThreads - 1) * L, e, nbits);
  __syncthreads();
  row_inverse<F>(acc, G, P, S, kTotThreads);
  for (long long i = stop - 1; i >= start; --i) {
    zk_load_v<L>(x, btot + i * L);
    uint32_t r[L];
    if (i > start) {
      // a coherent load: bpre was written by this kernel, so not __ldg
      zk_load<L>(r, bpre + (i - 1) * L);
      zk_mul<F>(r, r, acc);
    } else {
      zk_store<L>(r, acc);
    }
    zk_store_v<L>(btot + i * L, r);
    zk_mul<F>(acc, acc, x);
  }
}

// (3) each chunk's inverse from its block's, then the backward sweep
template <class F>
__global__ void __launch_bounds__(kBlock)
inv_sweep(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ ctot, const uint32_t* __restrict__ binv,
          long long n) {
  constexpr int L = F::L;
  __shared__ uint32_t P[kBlock * L], S[kBlock * L];
  const long long chunk = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long start = chunk * kChunk;
  const long long stop = start + kChunk < n ? start + kChunk : n;
  uint32_t acc[L], x[L], r[L];
  zk_load_v<L>(acc, ctot + chunk * L);
  zk_store<L>(P + threadIdx.x * L, acc);
  zk_store<L>(S + threadIdx.x * L, acc);
  __syncthreads();
  block_scan<F>(P, kBlock, false);
  block_scan<F>(S, kBlock, true);
  zk_load_v<L>(x, binv + (long long)blockIdx.x * L);
  row_inverse<F>(acc, x, P, S, kBlock);
  for (long long i = stop - 1; i >= start; --i) {
    zk_load_v<L>(x, a + i * L);
    if (zk_is_zero<F>(x)) {
#pragma unroll
      for (int j = 0; j < L; ++j) r[j] = 0;
    } else if (i > start) {
      zk_load_v<L>(r, out + (i - 1) * L);
      zk_mul<F>(r, r, acc);
      zk_mul<F>(acc, acc, x);
    } else {
      zk_store<L>(r, acc);
    }
    zk_store_v<L>(out + i * L, r);
  }
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

template <class F>
int launch_pow(const void* a, void* out, const void* e, int nbits,
               long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  field_pow<F><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, (const uint32_t*)e, nbits, n);
  return (int)cudaGetLastError();
}

template <class F>
int launch_batch_inv(const void* a, void* out, void* ctot, void* btot,
                     void* bpre, const void* one, const void* e, int nbits,
                     long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (n + kChunk * kBlock - 1) / (kChunk * kBlock);
  inv_chunk_prefix<F><<<(unsigned)blocks, kBlock, 0, st>>>(
      (const uint32_t*)a, (uint32_t*)out, (uint32_t*)ctot, (uint32_t*)btot,
      (const uint32_t*)one, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  inv_totals<F><<<1, kTotThreads, 0, st>>>(
      (uint32_t*)btot, (uint32_t*)bpre, (const uint32_t*)one,
      (const uint32_t*)e, nbits, blocks);
  err = (int)cudaGetLastError();
  if (err) return err;
  inv_sweep<F><<<(unsigned)blocks, kBlock, 0, st>>>(
      (const uint32_t*)a, (uint32_t*)out, (const uint32_t*)ctot,
      (const uint32_t*)btot, n);
  return (int)cudaGetLastError();
}

}  // namespace

// field: 0 = Fr (8 limbs), 1 = Fq (12 limbs). *_bcast: the operand is one
// row read by every element. Rows 16-byte aligned. Returns
// cudaGetLastError() after the launch.
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

// out[i] = a[i]^e for n rows; e: the exponent's u32 limbs (low first) on
// the card, nbits >= 1 its bit length.
extern "C" int zk_field_pow(const void* a, void* out, const void* e,
                            int nbits, long long n, int field, void* stream) {
  if (nbits < 1) return (int)cudaErrorInvalidValue;
  if (field == 0) return launch_pow<Fr>(a, out, e, nbits, n, stream);
  if (field == 1) return launch_pow<Fq>(a, out, e, nbits, n, stream);
  return (int)cudaErrorInvalidValue;
}

// out[i] = a[i]^-1 (0 for 0) for n rows in three launches. Scratch rows:
// ctot blocks * kBlock, btot and bpre blocks each, blocks = ceil(n /
// (kChunk kBlock)). one: the Montgomery one; e, nbits: p - 2 as for pow.
extern "C" int zk_batch_inv(const void* a, void* out, void* ctot, void* btot,
                            void* bpre, const void* one, const void* e,
                            int nbits, long long n, int field, void* stream) {
  if (nbits < 1) return (int)cudaErrorInvalidValue;
  if (field == 0)
    return launch_batch_inv<Fr>(a, out, ctot, btot, bpre, one, e, nbits, n,
                                stream);
  if (field == 1)
    return launch_batch_inv<Fq>(a, out, ctot, btot, bpre, one, e, nbits, n,
                                stream);
  return (int)cudaErrorInvalidValue;
}
