// K6: the fixed-base G1 ladder that turns the powers of tau into the SRS.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/parallel/srs_gen.py
//   fixed_base_msm_device (an XLA fori_loop of gathered Jacobian adds over
//   the 32 x 256 window table of _window_tables; no Pallas kernel), the
//   device half of generate_srs_device.
// Bound on this card: the integer multiply pipes. A power tau^i is the sum
//   of one table entry T[w][d_w] = d_w 2^(8 w) G for each nonzero byte d_w
//   of tau^i: up to 31 mixed XYZZ adds of 10 Fq products (576 32-bit
//   multiply-adds each) against 32 B of scalar read and 192 B of point
//   written, so the products set the time, as in K3's accumulation.
// Design: one thread a power. The thread reads its scalar's 32 bytes (one
//   8-word row, standard form), gathers the table entry of each nonzero
//   byte (6 16-byte loads through the read-only path: the table is 786 KB,
//   larger than shared memory, and stays in L2) and adds it into an XYZZ
//   sum with the complete mixed add of curve.cuh (P == Q doubles, P == -Q
//   gives infinity). Four blocks an SM cap it at 128 registers, as K3's
//   accumulation, which runs the same add. The caller normalizes to affine
//   with one Fq batch inversion (K1).
#include "curve.cuh"

namespace {

constexpr int SRS_BLOCK = 128;

// table: [32, 256, 2, 12] affine Montgomery, T[w][d] = d 2^(8 w) G (row d = 0
// unused); scalars: [n, 8] standard-form Fr words; out: [n, 4, 12] XYZZ.
__global__ void __launch_bounds__(SRS_BLOCK, 4)
fixed_base_ladder(const uint32_t* __restrict__ table,
                  const uint32_t* __restrict__ scalars, long long n,
                  uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Xyzz acc;
  set_inf(acc);
  for (int w = 0; w < 32; ++w) {
    const uint32_t word = __ldg(scalars + i * 8 + (w >> 2));
    const uint32_t d = (word >> (8 * (w & 3))) & 0xFFu;
    if (d == 0) continue;
    uint32_t qx[L], qy[L];
    load_affine(qx, qy, table + ((long long)w * 256 + d) * 2 * L);
    xyzz_madd(acc, qx, qy);
  }
  store_pt(out + i * PW, acc);
}

}  // namespace

// Runs the ladder on `stream` for n powers: table, scalars and out as
// fixed_base_ladder takes them.
extern "C" int zk_srs_fixed_base(const void* table, const void* scalars,
                                 long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  fixed_base_ladder<<<(unsigned)((n + SRS_BLOCK - 1) / SRS_BLOCK), SRS_BLOCK,
                      0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}
