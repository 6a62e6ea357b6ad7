// BLS12-377 G1 in extended Jacobian (XYZZ) coordinates over Montgomery Fq,
// and the bucket reduction shared by the two MSM kernels (K3 msm.cu, K4
// msm_u8.cu).
//
// A point is (X, Y, ZZ, ZZZ) with x = X / ZZ, y = Y / ZZZ and ZZ^3 = ZZZ^2;
// infinity is ZZ == 0. The formulas (madd-2008-s, add-2008-s, dbl-2008-s-1)
// take 10, 14 and 9 Fq products against 11, 16 and 7 in plain Jacobian, and
// all are COMPLETE here: P == Q doubles and P == -Q gives infinity, so no
// "no linear relation between points" contract of the TPU kernels is
// needed. An affine input point with x = y = 0 is infinity. Every function
// is inlined: operands stay in registers.
//
// The reduction (`reduce_windows`, then `window_ladder`) turns the partial
// sums of each bucket into one MSM point; a caller that cuts the windows
// into groups runs steps 0-3 once a group and the ladder once:
//   0. `segment_merge`, once per power of two up to the most partial sums a
//      bucket can have: each bucket's partial sums are joined pairwise, a
//      tree in place, so a bucket of many partial sums (the top window's
//      few buckets hold most of the window's points) costs log2 of their
//      number in sequence, not their number; the first partial sum of each
//      bucket is then its total. The caller counts each level's joins
//      (`merge_prefix`), so a level launches one thread per join. Then one
//      launch of `bucket_reduce`:
//   1. grid (blocks per window, windows), T threads a block: each thread
//      owns a slice of S buckets, adds each bucket's total into a running
//      sum from the top bucket down, and keeps (A, R) = (sum of (local
//      index + 1) B_j, sum of B_j) over its slice;
//   2. each thread adds k R to A, k = the number of buckets below its
//      slice, by double-and-add (at most log2(B) doublings): A is then the
//      slice's share sum_b b B_b of the window sum;
//   3. a sum tree in shared memory adds the block's shares, one add a
//      level; the last block of a window to finish (atomic ticket) adds
//      the window's block sums by the same tree: the window sum S_w;
//   4. `window_ladder`, one warp, runs the Horner ladder over the window
//      sums, sum_w 2^(c w) S_w, and writes the MSM point.
// Every step but the ladder and the top levels of the trees runs on all
// threads of the first step (W B / S of them), and nothing goes back to the
// host between the steps. The sequential depth, which sets the time here
// (one thread's Fq product takes over a microsecond), is the S adds of
// step 1, about 2 log2(B) curve operations in step 2, log2(B / S) adds in
// step 3 and c (W - 1) doublings in the ladder.
#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int L = Fq::L;
constexpr int PW = 4 * L;          // words of one XYZZ point
constexpr int MAX_BLOCK = 64;      // threads of a reduction block

struct Xyzz {
  uint32_t x[L], y[L], zz[L], zzz[L];
};

// The Fq product of the curve formulas: the PTX chains of field.cuh
// (fq_mul), or zk_mul<Fq> where a formula is instantiated with kPtx = false
// (the window ladder). On an H100, one thread's product takes 1.6-1.75 us
// with the PTX chains against 1.37 us with the C product
// (scripts/fq_latency.cu), so a lone chain of dependent products, the
// ladder, runs on the C product; across a full card the PTX chains add
// more points a second: K3's accumulation at 2^20 took 17.0 ms (PTX)
// against 18.2 ms (C), K4's lane scan 25.4 against 39.7 ms (measured with
// scripts/k3_variants.py on a build whose formulas all used zk_mul<Fq>).
template <bool kPtx>
ZK_DEV void fmul(uint32_t* out, const uint32_t* a, const uint32_t* b) {
  if (kPtx) {
    fq_mul(out, a, b);
  } else {
    zk_mul<Fq>(out, a, b);
  }
}

ZK_DEV void set_inf(Xyzz& p) {
#pragma unroll
  for (int j = 0; j < L; ++j) p.x[j] = p.y[j] = p.zz[j] = p.zzz[j] = 0;
}

ZK_DEV bool is_inf(const Xyzz& p) { return zk_is_zero<Fq>(p.zz); }

ZK_DEV void load_pt(Xyzz& p, const uint32_t* src) {
  zk_load<L>(p.x, src);
  zk_load<L>(p.y, src + L);
  zk_load<L>(p.zz, src + 2 * L);
  zk_load<L>(p.zzz, src + 3 * L);
}

// the same from device memory written by other blocks of this launch:
// ld.global.cg reads L2, never a stale L1 line
ZK_DEV void load_pt_cg(Xyzz& p, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    p.x[j] = __ldcg(src + j);
    p.y[j] = __ldcg(src + L + j);
    p.zz[j] = __ldcg(src + 2 * L + j);
    p.zzz[j] = __ldcg(src + 3 * L + j);
  }
}

ZK_DEV void store_pt(uint32_t* dst, const Xyzz& p) {
  zk_store<L>(dst, p.x);
  zk_store<L>(dst + L, p.y);
  zk_store<L>(dst + 2 * L, p.zz);
  zk_store<L>(dst + 3 * L, p.zzz);
}

// dbl-2008-s-1 (a = 0): U = 2Y, V = U^2, W = U V, S = X V, M = 3 X^2,
// X3 = M^2 - 2S, Y3 = M (S - X3) - W Y, ZZ3 = V ZZ, ZZZ3 = W ZZZ
template <bool kPtx = true>
ZK_DEV void xyzz_dbl(Xyzz& p) {
  if (is_inf(p)) return;
  uint32_t u[L], v[L], w[L], s[L], m[L];
  fq_add(u, p.y, p.y);
  fmul<kPtx>(v, u, u);
  fmul<kPtx>(w, u, v);
  fmul<kPtx>(s, p.x, v);
  fmul<kPtx>(m, p.x, p.x);
  fq_add(u, m, m);
  fq_add(m, u, m);
  fmul<kPtx>(p.zz, p.zz, v);
  fmul<kPtx>(p.zzz, p.zzz, w);
  fmul<kPtx>(w, w, p.y);
  fmul<kPtx>(u, m, m);
  fq_sub(u, u, s);
  fq_sub(p.x, u, s);
  fq_sub(u, s, p.x);
  fmul<kPtx>(u, m, u);
  fq_sub(p.y, u, w);
}

// madd-2008-s: p += (x2, y2), an affine finite point.
// P = x2 ZZ1 - X1, R = y2 ZZZ1 - Y1, PP = P^2, PPP = P PP, Q = X1 PP,
// X3 = R^2 - PPP - 2Q, Y3 = R (Q - X3) - Y1 PPP, ZZ3 = ZZ1 PP, ZZZ3 = ZZZ1 PPP
ZK_DEV void xyzz_madd(Xyzz& p, const uint32_t* x2, const uint32_t* y2) {
  if (is_inf(p)) {
    zk_load<L>(p.x, x2);
    zk_load<L>(p.y, y2);
    zk_load<L>(p.zz, ZK_FQ_ONE);
    zk_load<L>(p.zzz, ZK_FQ_ONE);
    return;
  }
  uint32_t pq[L], r[L];
  fq_mul(pq, x2, p.zz);
  fq_mul(r, y2, p.zzz);
  fq_sub(pq, pq, p.x);
  fq_sub(r, r, p.y);
  if (zk_is_zero<Fq>(pq)) {
    if (zk_is_zero<Fq>(r)) {
      xyzz_dbl(p);              // p == q
    } else {
      set_inf(p);               // p == -q
    }
    return;
  }
  uint32_t pp[L], ppp[L], q[L];
  fq_mul(pp, pq, pq);
  fq_mul(ppp, pq, pp);
  fq_mul(q, p.x, pp);
  fq_mul(p.zz, p.zz, pp);
  fq_mul(p.zzz, p.zzz, ppp);
  fq_mul(pq, r, r);
  fq_sub(pq, pq, ppp);
  fq_sub(pq, pq, q);
  fq_sub(pq, pq, q);            // X3
  fq_mul(ppp, p.y, ppp);
  fq_sub(q, q, pq);
  fq_mul(q, r, q);
  fq_sub(p.y, q, ppp);
  zk_store<L>(p.x, pq);
}

// add-2008-s: p += q. U1 = X1 ZZ2, S1 = Y1 ZZZ2, P = X2 ZZ1 - U1,
// R = Y2 ZZZ1 - S1, PP = P^2, PPP = P PP, Q = U1 PP, X3 = R^2 - PPP - 2Q,
// Y3 = R (Q - X3) - S1 PPP, ZZ3 = ZZ1 ZZ2 PP, ZZZ3 = ZZZ1 ZZZ2 PPP
template <bool kPtx = true>
ZK_DEV void xyzz_add(Xyzz& p, const Xyzz& q) {
  if (is_inf(q)) return;
  if (is_inf(p)) {
    p = q;
    return;
  }
  uint32_t u1[L], s1[L], pq[L], r[L];
  fmul<kPtx>(u1, p.x, q.zz);
  fmul<kPtx>(s1, p.y, q.zzz);
  fmul<kPtx>(pq, q.x, p.zz);
  fmul<kPtx>(r, q.y, p.zzz);
  fq_sub(pq, pq, u1);
  fq_sub(r, r, s1);
  if (zk_is_zero<Fq>(pq)) {
    if (zk_is_zero<Fq>(r)) {
      xyzz_dbl<kPtx>(p);
    } else {
      set_inf(p);
    }
    return;
  }
  uint32_t pp[L], ppp[L];
  fmul<kPtx>(pp, pq, pq);
  fmul<kPtx>(ppp, pq, pp);
  fmul<kPtx>(p.zz, p.zz, q.zz);
  fmul<kPtx>(p.zz, p.zz, pp);
  fmul<kPtx>(p.zzz, p.zzz, q.zzz);
  fmul<kPtx>(p.zzz, p.zzz, ppp);
  fmul<kPtx>(u1, u1, pp);           // Q
  fmul<kPtx>(pq, r, r);
  fq_sub(pq, pq, ppp);
  fq_sub(pq, pq, u1);
  fq_sub(pq, pq, u1);           // X3
  fmul<kPtx>(s1, s1, ppp);
  fq_sub(u1, u1, pq);
  fmul<kPtx>(u1, r, u1);
  fq_sub(p.y, u1, s1);
  zk_store<L>(p.x, pq);
}

// One affine input point [2, 12] as 6 16-byte loads through the read-only
// path; x = y = 0 (infinity) gives false.
ZK_DEV bool load_affine(uint32_t* qx, uint32_t* qy, const uint32_t* pt) {
  const uint4* v = reinterpret_cast<const uint4*>(pt);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint4 a = __ldg(v + k), b = __ldg(v + 3 + k);
    qx[4 * k] = a.x; qx[4 * k + 1] = a.y; qx[4 * k + 2] = a.z;
    qx[4 * k + 3] = a.w;
    qy[4 * k] = b.x; qy[4 * k + 1] = b.y; qy[4 * k + 2] = b.z;
    qy[4 * k + 3] = b.w;
  }
  return !(zk_is_zero<Fq>(qx) && zk_is_zero<Fq>(qy));
}

// The sum tree of steps 3 and 4 over n (a power of two, at most blockDim.x)
// points in shared memory: neighbours join pairwise, one add a level, and
// s[0] holds the sum of all n at the end.
ZK_DEV void add_tree(uint32_t (*s)[PW], int n) {
  const int tid = threadIdx.x;
  for (int lvl = 0; (1 << lvl) < n; ++lvl) {
    __syncthreads();
    if ((tid & ((2 << lvl) - 1)) == 0 && tid < n) {
      Xyzz u, t;
      load_pt(u, s[tid]);
      load_pt(t, s[tid + (1 << lvl)]);
      xyzz_add(u, t);
      store_pt(s[tid], u);
    }
  }
  __syncthreads();
}

// p += k r (k >= 0) by double-and-add from the top bit of k
ZK_DEV void add_multiple(Xyzz& p, const Xyzz& r, int k) {
  if (k == 0) return;
  Xyzz m = r;
  for (int bit = 30 - __clz(k); bit >= 0; --bit) {
    xyzz_dbl(m);
    if ((k >> bit) & 1) xyzz_add(m, r);
  }
  xyzz_add(p, m);
}

// Step 0: one level (stride = 2^p) of the pairwise join of each bucket's
// partial sums: partial first[t] + 2 j stride takes in the one `stride`
// past it. Thread u does the u-th join of the level: prefix[t] counts the
// joins of the buckets before t (prefix[n_buckets] all of them), so the
// busy threads are contiguous and no warp idles on a bucket that has
// nothing to join at this level. Four blocks an SM: 128 registers and 120 B
// of spills, yet on an H100 the levels of a 2^20 MSM took 2.192 ms (K3) and
// 1.773 ms (K4) against 2.257 and 1.883 ms with no cap (165 registers, no
// spills; scripts/k3_variants.py).
__global__ void __launch_bounds__(128, 4)
segment_merge(uint32_t* __restrict__ partial,
                              const long long* __restrict__ first,
                              const long long* __restrict__ prefix,
                              int n_buckets, long long stride) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= prefix[n_buckets]) return;
  int lo = 0, hi = n_buckets;     // prefix[lo] <= u < prefix[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= u) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const long long s = first[lo] + (u - prefix[lo]) * 2 * stride;
  Xyzz p, q;
  load_pt(p, partial + s * PW);
  load_pt(q, partial + (s + stride) * PW);
  xyzz_add(p, q);
  store_pt(partial + s * PW, p);
}

// Steps 1-3 above. partial: [*, 4, 12] XYZZ, the total of bucket t = w * B
// + b - 1 at first[t] when first[t] < first[t + 1] (else the bucket is
// empty); block_sums [W * bpw, 4, 12] scratch; counters [W] zeroed;
// window_sums [W, 4, 12] out.
__global__ void __launch_bounds__(MAX_BLOCK)
bucket_reduce(const uint32_t* __restrict__ partial,
              const long long* __restrict__ first, int buckets,
              int slice_log, int block_log,
              uint32_t* __restrict__ block_sums,
              uint32_t* __restrict__ window_sums,
              int* __restrict__ counters) {
  __shared__ uint32_t sA[MAX_BLOCK][PW];
  __shared__ int s_last;
  const int tid = threadIdx.x, blk = blockIdx.x, w = blockIdx.y;
  const int bpw = buckets >> (slice_log + block_log);
  {
    // step 1: running sums over this thread's slice, top bucket first
    Xyzz run, acc, q;
    set_inf(run);
    set_inf(acc);
    const int slice = (blk << block_log) + tid;
    const long long b0 = (long long)w * buckets + ((long long)slice << slice_log);
    for (int j = (1 << slice_log) - 1; j >= 0; --j) {
      const long long s = first[b0 + j];
      if (s < first[b0 + j + 1]) {
        load_pt(q, partial + s * PW);
        xyzz_add(run, q);
      }
      xyzz_add(acc, run);
    }
    // step 2: the slice's buckets start past bucket k = slice * 2^slice_log
    add_multiple(acc, run, slice << slice_log);
    store_pt(sA[tid], acc);
  }
  // step 3: the block's sum; the last block of the window sums the blocks'
  add_tree(sA, blockDim.x);
  if (tid == 0) {
    zk_store<PW>(block_sums + ((long long)w * bpw + blk) * PW, sA[0]);
    __threadfence();
    s_last = atomicAdd(&counters[w], 1) == bpw - 1;
  }
  __syncthreads();
  if (!s_last) return;                   // block-uniform
  __threadfence();
  if (tid < bpw) {
    Xyzz a;
    load_pt_cg(a, block_sums + ((long long)w * bpw + tid) * PW);
    store_pt(sA[tid], a);
  }
  add_tree(sA, bpw);
  if (tid == 0) zk_store<PW>(window_sums + (long long)w * PW, sA[0]);
}

// dst = lane's value of r from lane `src` (every lane of the warp calls)
ZK_DEV void from_lane(uint32_t* dst, const uint32_t* r, int src) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = __shfl_sync(0xffffffffu, r[j], src);
}

// dst = c ? a : b, element by element (dst may be b)
ZK_DEV void pick(uint32_t* dst, bool c, const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = c ? a[j] : b[j];
}

// xyzz_dbl on a whole warp that holds the same point in every lane: its
// nine products fall in three rounds of independent ones (2, 4 and 3), and
// lane k computes product k of a round, so a doubling waits for three
// products, not nine. One thread's product is bound by the pipe its warp
// instruction occupies, idle lanes included (two independent chains in one
// thread take twice as long, scripts/fq_latency.cu), so the other lanes'
// products cost nothing. Same values as xyzz_dbl, in every lane.
ZK_DEV void xyzz_dbl_warp(Xyzz& p) {
  if (is_inf(p)) return;
  const int lane = threadIdx.x & 31;
  uint32_t u[L], a[L], b[L], r[L], v[L], m[L];
  fq_add(u, p.y, p.y);                       // U = 2Y
  // round 1: V = U^2 (lane 0), X^2 (lane 1)
  pick(a, lane == 1, p.x, u);
  zk_mul<Fq>(r, a, a);
  from_lane(v, r, 0);
  from_lane(m, r, 1);
  fq_add(a, m, m);
  fq_add(m, a, m);                           // M = 3 X^2
  // round 2: W = U V (0), S = X V (1), ZZ3 = ZZ V (2), M^2 (3)
  pick(a, lane == 2, p.zz, m);
  pick(a, lane == 1, p.x, a);
  pick(a, lane == 0, u, a);
  pick(b, lane == 3, m, v);
  zk_mul<Fq>(r, a, b);
  uint32_t w[L], s[L];
  from_lane(w, r, 0);
  from_lane(s, r, 1);
  from_lane(p.zz, r, 2);
  from_lane(u, r, 3);
  fq_sub(u, u, s);
  fq_sub(p.x, u, s);                         // X3 = M^2 - 2S
  fq_sub(u, s, p.x);                         // S - X3
  // round 3: ZZZ3 = W ZZZ (0), W Y (1), M (S - X3) (2)
  pick(a, lane == 2, m, w);
  pick(b, lane == 1, p.y, u);
  pick(b, lane == 0, p.zzz, b);
  zk_mul<Fq>(r, a, b);
  from_lane(p.zzz, r, 0);
  from_lane(w, r, 1);
  from_lane(u, r, 2);
  fq_sub(p.y, u, w);                         // Y3 = M (S - X3) - W Y
}

// Step 4, one warp: sum_w 2^(c w) S_w from the top window down. A chain of
// c (W - 1) doublings, so its time is one thread's latency: every lane
// runs the ladder on the same values, the doublings spread their products
// over four lanes (xyzz_dbl_warp), the C product (lower latency than the
// PTX chains), and a launch of its own, whose registers nothing else
// shares. Lane 0 writes the point.
__global__ void __launch_bounds__(32)
window_ladder(const uint32_t* __restrict__ window_sums, int windows, int c,
              uint32_t* __restrict__ out) {
  Xyzz acc, t;
  set_inf(acc);
  for (int v = windows - 1; v >= 0; --v) {
    for (int e = 0; e < c; ++e) xyzz_dbl_warp(acc);
    load_pt(t, window_sums + (long long)v * PW);
    xyzz_add<false>(acc, t);
  }
  if (threadIdx.x == 0) store_pt(out, acc);
}

// Launches the merge levels (merge_passes of them: 2^merge_passes must
// reach the most partial sums of one bucket; merge_prefix [merge_passes,
// W*B + 1] int64, row p the running count of level p's joins over the
// buckets) and bucket_reduce on `s` over windows x buckets (buckets a power
// of two, divisible by 2^(slice_log + block_log), 2^block_log <=
// MAX_BLOCK): steps 0-3, the window sums. Returns the first launch error (0
// if none).
int reduce_windows(void* partial, const void* merge_prefix,
                   long long n_partial, const void* first, int merge_passes,
                   int windows, int buckets, int slice_log, int block_log,
                   void* block_sums, void* window_sums, void* counters,
                   cudaStream_t s) {
  const int threads = 128;
  const int n_buckets = windows * buckets;
  for (int p = 0; p < merge_passes && n_partial > 1; ++p) {
    // a level has at most n_partial / 2^p joins
    const long long joins = (n_partial + (1LL << p) - 1) >> p;
    segment_merge<<<(unsigned)((joins + threads - 1) / threads), threads, 0,
                    s>>>((uint32_t*)partial, (const long long*)first,
                         (const long long*)merge_prefix +
                             (long long)p * (n_buckets + 1),
                         n_buckets, 1LL << p);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  dim3 grid(buckets >> (slice_log + block_log), windows);
  bucket_reduce<<<grid, 1 << block_log, 0, s>>>(
      (const uint32_t*)partial, (const long long*)first, buckets, slice_log,
      block_log, (uint32_t*)block_sums, (uint32_t*)window_sums,
      (int*)counters);
  return (int)cudaGetLastError();
}

}  // namespace
