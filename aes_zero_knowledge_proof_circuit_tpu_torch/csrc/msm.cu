// K3: the signed-window Pippenger MSM over BLS12-377 G1, buckets to point.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_mxu.py _scan_kernel
//   (pallas_call in _scan_call, driven per window by _window_tables and
//   msm_mxu), together with the XLA tail merge and bit-decomposed fold that
//   turn its scan streams into window sums, and the host Horner ladder.
// Bound on this card: the integer multiply pipes. A mixed add is 10 Fq
//   products of 12 x 12 limbs (each 144 + 144 32-bit multiply-adds of the
//   product and the reduction, both halves: 576 IMAD) against 96 B of point
//   data, so the kernel needs enough threads, and no stalls on the point
//   gather, to keep those pipes busy; the reduction after it is a chain of
//   dependent curve operations, so there it is latency that counts.
// Design: the caller sorts the (window, point) digit pairs by bucket in torch
//   and cuts each bucket's run into segments of at most SEGMENT (32) pairs.
//   `segment_accumulate` gives each segment one thread that adds its points
//   (negated where the signed digit is negative) into an XYZZ sum with
//   complete mixed adds, fetching the next pair's point with cp.async (six
//   16-byte copies) into a second slot in shared memory while the current
//   add runs; its Fq products are the PTX carry chains of field.cuh with the
//   modulus as immediates, and four blocks an SM cap it at 128 registers.
//   Segments stay short: longer ones (64, 128 pairs) left fewer threads
//   than the card needs and were slower at 2^19 and 2^20, though they
//   shorten the merge (scripts/k3_variants.py with ops/msm.py's SEGMENT
//   set to 64 and 128). Then the shared reduction of curve.cuh: the segment
//   merge, bucket slices with offset multiples, sum trees and the window
//   ladder on one warp, so K3 returns the MSM as one XYZZ point that stays
//   on the device.
#include "curve.cuh"

namespace {

constexpr int ACC_BLOCK = 128;

ZK_DEV void cp_async16(void* smem, const void* gmem) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

ZK_DEV void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every group but the newest has landed
ZK_DEV void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one affine point [2, 12] (96 B) from device memory into a shared slot
ZK_DEV void prefetch_point(uint32_t* slot, const uint32_t* pt) {
#pragma unroll
  for (int k = 0; k < 6; ++k) cp_async16(slot + 4 * k, pt + 4 * k);
}

// One thread per segment of at most SEGMENT sorted pairs of one bucket (a
// bucket's run is cut into segments so that the few heavy buckets, such as
// the top window's, whose digits span only a few bits, do not serialize the
// whole MSM behind one thread). points: [N, 2, 12] affine Montgomery (x = y
// = 0 marks infinity); idx/neg: point index and sign of each sorted pair;
// [seg_lo, seg_hi): the segment's pairs; seg_out: [n_segs, 4, 12] XYZZ.
// Four blocks an SM: at most 128 registers a thread and 16 warps an SM to
// hide the products' latency. ptxas then spills 20 B, and that costs less
// than the warps: on an H100 the
// kernel took 17.220 ms at 2^20 and 9.487 ms at 2^19 against 19.382 and
// 10.774 ms at three blocks an SM (167 registers, no spills), and 17.0
// against 28.0 ms with no cap (243 registers); scripts/k3_variants.py.
__global__ void __launch_bounds__(ACC_BLOCK, 4)
segment_accumulate(const uint32_t* __restrict__ points,
                   const int* __restrict__ idx,
                   const uint8_t* __restrict__ neg,
                   const long long* __restrict__ seg_lo,
                   const long long* __restrict__ seg_hi, long long n_segs,
                   uint32_t* __restrict__ seg_out) {
  __shared__ __align__(16) uint32_t buf[2][ACC_BLOCK][2 * L];
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_segs) return;
  const long long lo = seg_lo[s];
  const int n = (int)(seg_hi[s] - lo);    // at most SEGMENT pairs
  const int* __restrict__ ix = idx + lo;
  const uint8_t* __restrict__ ng = neg + lo;
  Xyzz acc;
  set_inf(acc);
  if (n > 0) prefetch_point(buf[0][threadIdx.x], points + ix[0] * 2LL * L);
  cp_async_commit();
  for (int k = 0; k < n; ++k) {
    const int cur = k & 1;
    if (k + 1 < n)
      prefetch_point(buf[cur ^ 1][threadIdx.x], points + ix[k + 1] * 2LL * L);
    cp_async_commit();
    cp_async_wait_prev();
    uint32_t qx[L], qy[L];
    const uint4* v = reinterpret_cast<const uint4*>(buf[cur][threadIdx.x]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uint4 a = v[j], b = v[3 + j];
      qx[4 * j] = a.x; qx[4 * j + 1] = a.y; qx[4 * j + 2] = a.z;
      qx[4 * j + 3] = a.w;
      qy[4 * j] = b.x; qy[4 * j + 1] = b.y; qy[4 * j + 2] = b.z;
      qy[4 * j + 3] = b.w;
    }
    if (zk_is_zero<Fq>(qx) && zk_is_zero<Fq>(qy)) continue;
    if (ng[k]) {
      uint32_t zero[L];
#pragma unroll
      for (int j = 0; j < L; ++j) zero[j] = 0;
      fq_sub(qy, zero, qy);
    }
    xyzz_madd(acc, qx, qy);
  }
  store_pt(seg_out + s * PW, acc);
}

}  // namespace

// Runs the kernels on `stream` over the sorted pairs of one group of
// `windows` windows. seg_scratch [max(1, n_segs), 4, 12]; first: [W*B + 1]
// segment offsets of bucket w*B + b - 1 (w the group's own window index);
// merge_prefix, merge_passes, block_sums and counters (zeroed) as
// reduce_windows takes them; window_sums: the group's [windows, 4, 12] rows
// of the MSM's window sums. When ladder_windows > 0 (the last group), the
// ladder then runs over all_sums, the MSM's [ladder_windows, 4, 12] window
// sums, into out: the MSM as one XYZZ point [4, 12] in Montgomery form. A
// single group is the whole MSM: window_sums = all_sums, ladder_windows =
// windows.
extern "C" int zk_msm_g1(const void* points, const void* idx, const void* neg,
                         const void* seg_lo, const void* seg_hi,
                         const void* merge_prefix, long long n_segs,
                         const void* first, int merge_passes, int windows,
                         int buckets, int c, int slice_log, int block_log,
                         void* seg_scratch, void* block_sums,
                         void* window_sums, void* counters,
                         const void* all_sums, int ladder_windows, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_segs > 0) {
    segment_accumulate<<<(unsigned)((n_segs + ACC_BLOCK - 1) / ACC_BLOCK),
                         ACC_BLOCK, 0, s>>>(
        (const uint32_t*)points, (const int*)idx, (const uint8_t*)neg,
        (const long long*)seg_lo, (const long long*)seg_hi, n_segs,
        (uint32_t*)seg_scratch);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  int err = reduce_windows(seg_scratch, merge_prefix, n_segs, first,
                           merge_passes, windows, buckets, slice_log,
                           block_log, block_sums, window_sums, counters, s);
  if (err || ladder_windows <= 0) return err;
  window_ladder<<<1, 32, 0, s>>>((const uint32_t*)all_sums, ladder_windows, c,
                                 (uint32_t*)out);
  return (int)cudaGetLastError();
}
