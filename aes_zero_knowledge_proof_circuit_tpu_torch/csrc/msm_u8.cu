// K4: the 8-bit bucket-scan MSM over BLS12-377 G1.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_pallas.py _scan_kernel
//   (pallas_call in _scan_call), together with the XLA tail scatter, lane
//   merge and suffix fold of _bucket_tables and _suffix_fold that turn its
//   scan streams into window sums.
// Bound on this card: integer multiplies, as K3. A mixed Jacobian add is 11
//   Fq products of 12x12 limbs against 96 B of point data; the scan is
//   n * 32 such adds per MSM, and it needs enough threads to keep the
//   multiply pipes busy.
// Design: B5's own work split. The caller (ops/msm_pallas.land) sorts each
//   window's (point, digit) pairs by the unsigned 8-bit digit and lands them
//   column-major as [W, steps, lanes]: lane j owns the sorted run
//   [j*steps, (j+1)*steps) across bucket boundaries, so every lane has the
//   same work whatever the digits (the top window's 5-bit digits included),
//   and the lanes of one step read adjacent words. Kernel 1 gives each
//   (window, lane) one thread that scans its slice with complete mixed adds
//   and, at each change of digit, writes the finished (lane, bucket) run as
//   one tail and restarts from infinity. The TPU kernel writes every running
//   sum and scatters the tails afterwards; here only the tails are written,
//   at the slots the caller counted (lane_base), in (window, digit) order.
//   Digit 0 is the dump bucket: its pairs are skipped and leave no tail.
//   The tails of one bucket from adjacent lanes can be equal or opposite
//   points, so the lane merge sums them with the complete adds of the shared
//   reduction passes (curve.cuh), which then fold the buckets:
//   sum_{j>=1} sum_{d>=j} B_d = sum_d d B_d, as chunked running sums.
#include "curve.cuh"

namespace {

// One thread per (window w, lane j). points: [N, 2, 12] affine Montgomery;
// order/digits: [W, steps, lanes] point index and digit of each sorted pair;
// lane_base[t]: the first tail slot of lane t = w * lanes + j.
__global__ void lane_scan(const uint32_t* __restrict__ points,
                          const int* __restrict__ order,
                          const uint8_t* __restrict__ digits, int lanes,
                          int steps, long long n_lanes,
                          const long long* __restrict__ lane_base,
                          uint32_t* __restrict__ tails) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  long long w = t / lanes;
  long long j = t - w * lanes;
  long long k = w * steps * lanes + j;
  long long slot = lane_base[t];
  Jac acc;
  set_inf(acc);
  int prev = 0;
  for (int s = 0; s < steps; ++s, k += lanes) {
    int d = digits[k];
    if (d != prev) {
      if (prev != 0) {
        store_jac(tails + slot * 3 * L, acc);
        ++slot;
        set_inf(acc);
      }
      prev = d;
    }
    if (d == 0) continue;
    const uint32_t* pt = points + (long long)order[k] * 2 * L;
    uint32_t qx[L], qy[L];
    zk_load<L>(qx, pt);
    zk_load<L>(qy, pt + L);
    if (zk_is_zero<Fq>(qx) && zk_is_zero<Fq>(qy)) continue;
    jac_madd(acc, qx, qy);
  }
  if (prev != 0) store_jac(tails + slot * 3 * L, acc);
}

}  // namespace

// Runs the scan and the reduction passes on `stream`. tails: [n_tails, 3,
// 12] scratch; first: [W*256 + 1] tail offsets of bucket w*256 + d - 1;
// bucket_scratch [W*256, 3, 12], chunk_scratch [W*(256/chunk), 2, 3, 12];
// out: [W, 3, 12] Jacobian window sums in Montgomery form.
extern "C" int zk_msm_u8(const void* points, const void* order,
                         const void* digits, int windows, int lanes,
                         int steps, const void* lane_base, const void* first,
                         int chunk, int log_chunk, void* tails,
                         void* bucket_scratch, void* chunk_scratch, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  long long n_lanes = (long long)windows * lanes;
  lane_scan<<<(unsigned)((n_lanes + threads - 1) / threads), threads, 0, s>>>(
      (const uint32_t*)points, (const int*)order, (const uint8_t*)digits,
      lanes, steps, n_lanes, (const long long*)lane_base, (uint32_t*)tails);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_buckets(tails, first, windows, 256, chunk, log_chunk,
                        bucket_scratch, chunk_scratch, out, s);
}
