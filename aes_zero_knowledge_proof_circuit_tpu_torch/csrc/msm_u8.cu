// K4: the 8-bit bucket-scan MSM over BLS12-377 G1.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_pallas.py _scan_kernel
//   (pallas_call in _scan_call), together with the XLA tail scatter, lane
//   merge and suffix fold of _bucket_tables and _suffix_fold that turn its
//   scan streams into window sums.
// Bound on this card: integer multiplies, as K3. A mixed XYZZ add is 10 Fq
//   products of 12x12 limbs against 96 B of point data; the scan is
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
//   reduction (curve.cuh), which then folds the buckets,
//   sum_{j>=1} sum_{d>=j} B_d = sum_d d B_d, by slices and offset-doubling
//   trees, and the 32 windows by the Horner ladder (c = 8): K4 returns the
//   MSM as one XYZZ point, as K3 does.
#include "curve.cuh"

namespace {

// One thread per (window w, lane j). points: [N, 2, 12] affine Montgomery;
// order/digits: [W, steps, lanes] point index and digit of each sorted pair;
// lane_base[t]: the first tail slot of lane t = w * lanes + j. Four blocks of
// 128 an SM, as K3's accumulation: 128 registers and no spills; on an H100
// the scan at 2^20 took 26.557 ms against 30.502 ms at three blocks an SM
// (167 registers; scripts/k3_variants.py).
__global__ void __launch_bounds__(128, 4)
lane_scan(const uint32_t* __restrict__ points,
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
  Xyzz acc;
  set_inf(acc);
  int prev = 0;
  for (int s = 0; s < steps; ++s, k += lanes) {
    int d = digits[k];
    if (d != prev) {
      if (prev != 0) {
        store_pt(tails + slot * PW, acc);
        ++slot;
        set_inf(acc);
      }
      prev = d;
    }
    if (d == 0) continue;
    uint32_t qx[L], qy[L];
    if (!load_affine(qx, qy, points + (long long)order[k] * 2 * L)) continue;
    xyzz_madd(acc, qx, qy);
  }
  if (prev != 0) store_pt(tails + slot * PW, acc);
}

}  // namespace

// Runs the scan and the reduction on `stream`. tails: [max(1, n_tails), 4,
// 12] scratch; first: [W*256 + 1] tail offsets of bucket w*256 + d - 1;
// merge_prefix, merge_passes, block_sums, window_sums, counters (zeroed)
// and out as reduce_msm takes them; out: the MSM as one XYZZ point [4, 12]
// in Montgomery form.
extern "C" int zk_msm_u8(const void* points, const void* order,
                         const void* digits, int windows, int lanes,
                         int steps, const void* lane_base, const void* first,
                         const void* merge_prefix, long long n_tails,
                         int merge_passes, int slice_log, int block_log,
                         void* tails, void* block_sums, void* window_sums,
                         void* counters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  long long n_lanes = (long long)windows * lanes;
  lane_scan<<<(unsigned)((n_lanes + threads - 1) / threads), threads, 0, s>>>(
      (const uint32_t*)points, (const int*)order, (const uint8_t*)digits,
      lanes, steps, n_lanes, (const long long*)lane_base, (uint32_t*)tails);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_msm(tails, merge_prefix, n_tails, first, merge_passes, windows,
                    256, 8, slice_log, block_log, block_sums, window_sums,
                    counters, out, s);
}
