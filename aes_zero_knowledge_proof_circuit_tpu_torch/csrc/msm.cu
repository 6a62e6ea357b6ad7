// K3: Pippenger bucket accumulation and bucket reduction over BLS12-377 G1.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_mxu.py _scan_kernel
//   (pallas_call in _scan_call, driven per window by _window_tables and
//   msm_mxu), together with the XLA tail merge and bit-decomposed fold that
//   turn its scan streams into window sums.
// Bound on this card: integer multiplies. A mixed Jacobian add is 11 Fq
//   products of 12x12 limbs (~3.5k 32-bit multiply-adds) against 96 B of
//   point data, so the kernel is bound by the multiply pipes and by how many
//   threads keep them busy.
// Design: the caller sorts the (window, point) digit pairs by bucket in torch
//   and cuts each bucket's run into segments of at most T pairs. Kernel 1
//   gives each segment one thread that adds its points, negated where the
//   signed digit is negative, with complete formulas (P == Q doubles,
//   P == -Q gives infinity), so the TPU kernel's "no linear relation between
//   points" contract is not needed; kernel 2 adds each bucket's segments.
//   Kernel 3 cuts each window's buckets into chunks of CH and reduces each
//   chunk by a running sum; kernel 4 combines a window's chunks with a second
//   running sum. The window Horner ladder stays on the host, as in msm_mxu.
//   Finer load balancing and a field multiply on the tensor cores are later
//   work.
#include "curve.cuh"

namespace {

// One thread per segment of at most T sorted pairs of one bucket (a bucket's
// run is cut into segments so that the few heavy buckets — e.g. the top
// window's, whose digits span only a few bits — do not serialize the whole
// MSM behind one thread). points: [N, 2, 12] affine Montgomery (x = y = 0
// marks infinity); idx/neg: point index and sign of each sorted pair;
// [seg_lo, seg_hi): the segment's pairs.
__global__ void segment_accumulate(const uint32_t* __restrict__ points,
                                   const int* __restrict__ idx,
                                   const uint8_t* __restrict__ neg,
                                   const long long* __restrict__ seg_lo,
                                   const long long* __restrict__ seg_hi,
                                   long long n_segs,
                                   uint32_t* __restrict__ seg_out) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_segs) return;
  Jac acc;
  set_inf(acc);
  for (long long k = seg_lo[s]; k < seg_hi[s]; ++k) {
    const uint32_t* pt = points + (long long)idx[k] * 2 * L;
    uint32_t qx[L], qy[L];
    zk_load<L>(qx, pt);
    zk_load<L>(qy, pt + L);
    if (zk_is_zero<Fq>(qx) && zk_is_zero<Fq>(qy)) continue;
    if (neg[k]) {
      uint32_t zero[L];
#pragma unroll
      for (int j = 0; j < L; ++j) zero[j] = 0;
      zk_sub<Fq>(qy, zero, qy);
    }
    jac_madd(acc, qx, qy);
  }
  store_jac(seg_out + s * 3 * L, acc);
}

}  // namespace

// Runs the phases on `stream`. Scratch: seg_scratch [n_segs, 3, 12],
// bucket_scratch [W*B, 3, 12], chunk_scratch [W*(B/chunk), 2, 3, 12]; out:
// [W, 3, 12] Jacobian window sums in Montgomery form. first: [W*B + 1]
// segment offsets per bucket. chunk must be a power of two dividing B.
extern "C" int zk_msm_g1(const void* points, const void* idx, const void* neg,
                         const void* seg_lo, const void* seg_hi,
                         long long n_segs, const void* first, int windows,
                         int buckets, int chunk, int log_chunk,
                         void* seg_scratch, void* bucket_scratch,
                         void* chunk_scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  if (n_segs > 0) {
    segment_accumulate<<<(unsigned)((n_segs + threads - 1) / threads),
                         threads, 0, s>>>(
        (const uint32_t*)points, (const int*)idx, (const uint8_t*)neg,
        (const long long*)seg_lo, (const long long*)seg_hi, n_segs,
        (uint32_t*)seg_scratch);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return reduce_buckets(seg_scratch, first, windows, buckets, chunk,
                        log_chunk, bucket_scratch, chunk_scratch, out, s);
}
