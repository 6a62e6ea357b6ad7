// K2: radix-2 decimation-in-time NTT over Fr, several stages a launch.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/pallas_field.py
//   _butterfly_kernel (pallas_call in _butterfly_call, reached through
//   pallas_butterfly), the stage body of ops/ntt_jax.py NTTEngine._core.
// Bound on this card: operations. A transform of 2^k elements does
//   k 2^(k-1) Montgomery products (~256 32-bit multiply-adds each) and,
//   in two passes, moves the array four times: at 2^20 about 0.16 ms of
//   multiply-adds against 0.04 ms of bytes (H100 SXM: 16.7 T multiply-adds
//   a second, 3.35 TB/s).
// Design: one launch per pass. A pass runs s <= 10 consecutive stages
//   t0 .. t0 + s - 1. Those stages mix only elements whose indices differ
//   in bits t0 .. t0 + s - 1, so the array splits into n / 2^s independent
//   tiles of 2^s elements spaced 2^t0 apart; a block loads one tile into
//   shared memory (each element two 16-byte vectors: a whole 32-byte
//   sector), runs the s stages there and writes the tile back once. The
//   first pass (t0 = 0) reads element bitrev(i) of the input, so the bit
//   reversal costs no pass of its own; the last may scale every element
//   by one constant (1/n for the inverse). At 2^18-2^20 a transform is two
//   passes. Twiddles are read from the single [n/2, 8] table of omega
//   powers (stage t, offset j: omega^(j n / 2^(t+1))): it fits in L2 (16 MB
//   at 2^20), where per-pass tables in read order would cost another n
//   elements of device memory for each size and direction. The product is
//   the C CIOS zk_mul<Fr>: a PTX carry-chain Fr product like K3's Fq one
//   took 0.438 against 0.416 ms at 2^20 on an NVIDIA H100 80GB HBM3 at
//   700 W (scripts/time_field_ntt.py, PERF.md). Shared memory holds the
//   tile as two planes of 16-byte halves, so neighbouring threads hit
//   neighbouring banks.
// Batch: `batch` independent transforms of 2^log_n rows lie back to back
//   (the four-step NTT's rows, parallel/sharded_ntt.py); blockIdx.y picks
//   the transform and offsets the tile by blockIdx.y << log_n. batch = 1
//   is the single transform's launch.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kMaxPassLog = 10;     // tiles of at most 1024 elements (32 KB)
constexpr int kThreads = 256;
constexpr int kMaxBatch = 65535;   // gridDim.y

ZK_DEV void tile_get(uint32_t* v, const uint4* tile, int T, int e) {
  uint4 lo = tile[e], hi = tile[T + e];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

ZK_DEV void tile_put(uint4* tile, int T, int e, const uint32_t* v) {
  tile[e] = make_uint4(v[0], v[1], v[2], v[3]);
  tile[T + e] = make_uint4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(kThreads, 2)
ntt_pass(const uint32_t* src, uint32_t* dst,   // may alias (in place)
         const uint32_t* __restrict__ tw, const uint32_t* __restrict__ scale,
         int log_n, int t0, int s, int bitrev) {
  extern __shared__ uint4 tile[];
  const int T = 1 << s;
  const long long n = 1LL << log_n;
  const long long lo = blockIdx.x & ((1LL << t0) - 1);
  const long long hi = (long long)blockIdx.x >> t0;
  const long long base = (hi << (t0 + s)) | lo;    // element 0 of the tile
  const long long row = (long long)blockIdx.y << log_n;   // the transform
  uint32_t v[8];

  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    long long g = base + ((long long)e << t0);
    if (bitrev) g = __brevll((unsigned long long)g) >> (64 - log_n);
    zk_load_v<8>(v, src + (row + g) * 8);
    tile_put(tile, T, e, v);
  }
  __syncthreads();

  for (int u = 0; u < s; ++u) {
    const int h = 1 << u;
    const long long tw_step = n >> (t0 + u + 1);
    for (int b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const int j = b & (h - 1);
      const int m0 = ((b >> u) << (u + 1)) | j;
      uint32_t l[8], r[8], w[8];
      tile_get(l, tile, T, m0);
      tile_get(r, tile, T, m0 + h);
      zk_load_v<8>(w, tw + ((((long long)j << t0) | lo) * tw_step) * 8);
      zk_mul<Fr>(r, r, w);
      zk_add<Fr>(w, l, r);
      zk_sub<Fr>(l, l, r);
      tile_put(tile, T, m0, w);
      tile_put(tile, T, m0 + h, l);
    }
    // the next stage's groups of 2^(u + 2) elements lie inside the 64
    // elements a warp's butterflies covered in this one while u + 2 <= 6
    if (u + 2 <= 6)
      __syncwarp();
    else
      __syncthreads();
  }
  __syncthreads();

  uint32_t c[8];
  if (scale) zk_load_v<8>(c, scale);
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    tile_get(v, tile, T, e);
    if (scale) zk_mul<Fr>(v, v, c);
    zk_store_v<8>(dst + (row + base + ((long long)e << t0)) * 8, v);
  }
}

}  // namespace

// One pass: stages t0 .. t0 + s - 1 of the DIT transforms of `batch`
// independent rows of 2^log_n Fr elements each ([batch, n, 8] Montgomery
// limbs, 16-byte aligned), from src to dst (the same array after the first
// pass; never the same with bitrev, which reads src in bit-reversed
// order). tw: [n/2, 8] omega^j. scale: one element every output is
// multiplied by, or null. batch <= kMaxBatch (gridDim.y).
extern "C" int zk_ntt_pass(const void* src, void* dst, const void* tw,
                           const void* scale, int log_n, int t0, int s,
                           int bitrev, int batch, void* stream) {
  if (log_n < 1 || log_n > 30 || s < 1 || s > kMaxPassLog || t0 < 0 ||
      t0 + s > log_n || (bitrev && src == dst) || batch < 1 ||
      batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const int T = 1 << s;
  const int threads = T / 2 < kThreads ? (T / 2 < 32 ? 32 : T / 2) : kThreads;
  const dim3 grid((unsigned)(1LL << (log_n - s)), (unsigned)batch);
  ntt_pass<<<grid, threads, T * 32, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (uint32_t*)dst, (const uint32_t*)tw,
      (const uint32_t*)scale, log_n, t0, s, bitrev);
  return (int)cudaGetLastError();
}
