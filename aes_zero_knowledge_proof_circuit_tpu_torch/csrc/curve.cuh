// BLS12-377 G1 in Jacobian coordinates over Montgomery Fq, and the bucket
// reduction passes, shared by the two MSM kernels (K3 msm.cu, K4 msm_u8.cu).
//
// All formulas are COMPLETE: P == Q doubles and P == -Q gives infinity, so
// no "no linear relation between points" contract of the TPU kernels is
// needed. Infinity is z == 0; an affine input point with x = y = 0 is
// infinity.
#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int L = Fq::L;

struct Jac {
  uint32_t x[L], y[L], z[L];
};

ZK_DEV void set_inf(Jac& p) {
#pragma unroll
  for (int j = 0; j < L; ++j) p.x[j] = p.y[j] = p.z[j] = 0;
}

ZK_DEV bool is_inf(const Jac& p) { return zk_is_zero<Fq>(p.z); }

// dbl-2009-l (a = 0). The doubling and the full add are out of line: the
// reduction phases call them from several sites, and one copy each keeps
// the build short (they are not the hot loop; the mixed add is).
__device__ __noinline__ void jac_double(Jac& p) {
  if (is_inf(p)) return;
  uint32_t a[L], b[L], c[L], d[L], e[L], f[L], t[L];
  zk_mul<Fq>(t, p.y, p.z);
  zk_add<Fq>(p.z, t, t);            // Z3 = 2YZ
  zk_mul<Fq>(a, p.x, p.x);          // A = X^2
  zk_mul<Fq>(b, p.y, p.y);          // B = Y^2
  zk_mul<Fq>(c, b, b);              // C = B^2
  zk_add<Fq>(t, p.x, b);
  zk_mul<Fq>(t, t, t);
  zk_sub<Fq>(t, t, a);
  zk_sub<Fq>(t, t, c);
  zk_add<Fq>(d, t, t);              // D = 2((X+B)^2 - A - C)
  zk_add<Fq>(e, a, a);
  zk_add<Fq>(e, e, a);              // E = 3A
  zk_mul<Fq>(f, e, e);              // F = E^2
  zk_add<Fq>(t, d, d);
  zk_sub<Fq>(p.x, f, t);            // X3 = F - 2D
  zk_sub<Fq>(t, d, p.x);
  zk_mul<Fq>(t, e, t);
  zk_add<Fq>(c, c, c);
  zk_add<Fq>(c, c, c);
  zk_add<Fq>(c, c, c);              // 8C
  zk_sub<Fq>(p.y, t, c);            // Y3 = E(D - X3) - 8C
}

// madd-2007-bl: p += (qx, qy) with q affine and finite
ZK_DEV void jac_madd(Jac& p, const uint32_t* qx, const uint32_t* qy) {
  if (is_inf(p)) {
    zk_load<L>(p.x, qx);
    zk_load<L>(p.y, qy);
    zk_load<L>(p.z, ZK_FQ_ONE);
    return;
  }
  uint32_t z1z1[L], u2[L], s2[L], h[L], rr[L], t[L];
  zk_mul<Fq>(z1z1, p.z, p.z);
  zk_mul<Fq>(u2, qx, z1z1);
  zk_mul<Fq>(s2, qy, p.z);
  zk_mul<Fq>(s2, s2, z1z1);
  zk_sub<Fq>(h, u2, p.x);
  zk_sub<Fq>(rr, s2, p.y);
  if (zk_is_zero<Fq>(h)) {
    if (zk_is_zero<Fq>(rr)) {
      jac_double(p);
    } else {
      set_inf(p);
    }
    return;
  }
  uint32_t hh[L], i4[L], j[L], r[L], v[L];
  zk_mul<Fq>(hh, h, h);
  zk_add<Fq>(i4, hh, hh);
  zk_add<Fq>(i4, i4, i4);           // I = 4HH
  zk_mul<Fq>(j, h, i4);             // J = H*I
  zk_add<Fq>(r, rr, rr);            // r = 2(S2 - Y1)
  zk_mul<Fq>(v, p.x, i4);           // V = X1*I
  // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  zk_add<Fq>(t, p.z, h);
  zk_mul<Fq>(t, t, t);
  zk_sub<Fq>(t, t, z1z1);
  zk_sub<Fq>(p.z, t, hh);
  // X3 = r^2 - J - 2V
  zk_mul<Fq>(t, r, r);
  zk_sub<Fq>(t, t, j);
  zk_sub<Fq>(t, t, v);
  zk_sub<Fq>(t, t, v);
  // Y3 = r(V - X3) - 2 Y1 J
  zk_sub<Fq>(v, v, t);
  zk_mul<Fq>(v, r, v);
  zk_mul<Fq>(j, p.y, j);
  zk_add<Fq>(j, j, j);
  zk_sub<Fq>(p.y, v, j);
  zk_store<L>(p.x, t);
}

// add-2007-bl: p += q, both Jacobian
__device__ __noinline__ void jac_add(Jac& p, const Jac& q) {
  if (is_inf(q)) return;
  if (is_inf(p)) {
    p = q;
    return;
  }
  uint32_t z1z1[L], z2z2[L], u1[L], u2[L], s1[L], s2[L], h[L], rr[L];
  zk_mul<Fq>(z1z1, p.z, p.z);
  zk_mul<Fq>(z2z2, q.z, q.z);
  zk_mul<Fq>(u1, p.x, z2z2);
  zk_mul<Fq>(u2, q.x, z1z1);
  zk_mul<Fq>(s1, p.y, q.z);
  zk_mul<Fq>(s1, s1, z2z2);
  zk_mul<Fq>(s2, q.y, p.z);
  zk_mul<Fq>(s2, s2, z1z1);
  zk_sub<Fq>(h, u2, u1);
  zk_sub<Fq>(rr, s2, s1);
  if (zk_is_zero<Fq>(h)) {
    if (zk_is_zero<Fq>(rr)) {
      jac_double(p);
    } else {
      set_inf(p);
    }
    return;
  }
  uint32_t i4[L], j[L], r[L], v[L], t[L];
  zk_add<Fq>(i4, h, h);
  zk_mul<Fq>(i4, i4, i4);           // I = (2H)^2
  zk_mul<Fq>(j, h, i4);             // J = H*I
  zk_add<Fq>(r, rr, rr);            // r = 2(S2 - S1)
  zk_mul<Fq>(v, u1, i4);            // V = U1*I
  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  zk_add<Fq>(t, p.z, q.z);
  zk_mul<Fq>(t, t, t);
  zk_sub<Fq>(t, t, z1z1);
  zk_sub<Fq>(t, t, z2z2);
  zk_mul<Fq>(p.z, t, h);
  // X3 = r^2 - J - 2V
  zk_mul<Fq>(t, r, r);
  zk_sub<Fq>(t, t, j);
  zk_sub<Fq>(t, t, v);
  zk_sub<Fq>(t, t, v);
  zk_store<L>(p.x, t);
  // Y3 = r(V - X3) - 2 S1 J
  zk_sub<Fq>(v, v, t);
  zk_mul<Fq>(v, r, v);
  zk_mul<Fq>(j, s1, j);
  zk_add<Fq>(j, j, j);
  zk_sub<Fq>(p.y, v, j);
}

ZK_DEV void load_jac(Jac& p, const uint32_t* src) {
  zk_load<L>(p.x, src);
  zk_load<L>(p.y, src + L);
  zk_load<L>(p.z, src + 2 * L);
}

ZK_DEV void store_jac(uint32_t* dst, const Jac& p) {
  zk_store<L>(dst, p.x);
  zk_store<L>(dst + L, p.y);
  zk_store<L>(dst + 2 * L, p.z);
}

// One thread per (window w, bucket b in 1..B), t = w * B + b - 1: the sum of
// the bucket's segments [first[t], first[t + 1]).
__global__ void bucket_merge(const uint32_t* __restrict__ seg_sums,
                             const long long* __restrict__ first,
                             int n_buckets, uint32_t* __restrict__ bucket_out) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_buckets) return;
  Jac acc, q;
  set_inf(acc);
  for (long long s = first[t]; s < first[t + 1]; ++s) {
    load_jac(q, seg_sums + s * 3 * L);
    jac_add(acc, q);
  }
  store_jac(bucket_out + (long long)t * 3 * L, acc);
}

// One thread per (window, chunk of CH buckets): A = sum_j (j+1) B_j and
// R = sum_j B_j over the chunk, by a running sum from the top bucket down.
__global__ void bucket_chunk_reduce(const uint32_t* __restrict__ bucket_sums,
                                    int windows, int buckets, int chunk,
                                    uint32_t* __restrict__ chunk_out) {
  int nch = buckets / chunk;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= windows * nch) return;
  int w = t / nch;
  int c = t - w * nch;
  const uint32_t* base = bucket_sums + ((long long)w * buckets + (long long)c * chunk) * 3 * L;
  Jac run, acc, q;
  set_inf(run);
  set_inf(acc);
  for (int j = chunk - 1; j >= 0; --j) {
    load_jac(q, base + (long long)j * 3 * L);
    jac_add(run, q);
    jac_add(acc, run);
  }
  store_jac(chunk_out + (long long)t * 6 * L, acc);
  store_jac(chunk_out + (long long)t * 6 * L + 3 * L, run);
}

// One thread per window: S = sum_c A_c + CH * sum_c c R_c.
__global__ void window_combine(const uint32_t* __restrict__ chunk_sums,
                               int windows, int nch, int log_chunk,
                               uint32_t* __restrict__ window_out) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= windows) return;
  const uint32_t* base = chunk_sums + (long long)w * nch * 6 * L;
  Jac run, acc, q;
  set_inf(run);
  set_inf(acc);
  for (int c = nch - 1; c >= 1; --c) {
    load_jac(q, base + (long long)c * 6 * L + 3 * L);
    jac_add(run, q);
    jac_add(acc, run);
  }
  for (int k = 0; k < log_chunk; ++k) jac_double(acc);
  for (int c = 0; c < nch; ++c) {
    load_jac(q, base + (long long)c * 6 * L);
    jac_add(acc, q);
  }
  store_jac(window_out + (long long)w * 3 * L, acc);
}

// The three reduction passes on `s`: bucket totals from the partial sums
// [first[t], first[t + 1]) of bucket t = w * B + b - 1, then the chunked
// running sums to one Jacobian window sum sum_b b * B_b per window.
// Returns the first launch error (0 if none).
int reduce_buckets(const void* partial, const void* first, int windows,
                   int buckets, int chunk, int log_chunk, void* bucket_scratch,
                   void* chunk_scratch, void* out, cudaStream_t s) {
  const int threads = 128;
  int n1 = windows * buckets;
  bucket_merge<<<(n1 + threads - 1) / threads, threads, 0, s>>>(
      (const uint32_t*)partial, (const long long*)first, n1,
      (uint32_t*)bucket_scratch);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int n2 = windows * (buckets / chunk);
  bucket_chunk_reduce<<<(n2 + threads - 1) / threads, threads, 0, s>>>(
      (const uint32_t*)bucket_scratch, windows, buckets, chunk,
      (uint32_t*)chunk_scratch);
  err = (int)cudaGetLastError();
  if (err) return err;
  window_combine<<<(windows + 31) / 32, 32, 0, s>>>(
      (const uint32_t*)chunk_scratch, windows, buckets / chunk, log_chunk,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace
