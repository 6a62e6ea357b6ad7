// K4: the 8-bit bucket MSM over BLS12-377 G1, with batch-affine bucket sums.
//
// Replaces: aes_zero_knowledge_proof_circuit_tpu/ops/msm_pallas.py _scan_kernel
//   (pallas_call in _scan_call), together with the XLA tail scatter, lane
//   merge and suffix fold of _bucket_tables and _suffix_fold that turn its
//   scan streams into window sums.
// Bound on this card: integer multiplies. The buckets of one MSM take n * 32
//   point additions less one a bucket, whatever their order; the lane scan
//   this replaces did each as a mixed XYZZ add of 10 Fq products. An affine
//   add costs 3 products (lambda, lambda^2, lambda (x1 - x3)) once the
//   inverse of its denominator is known, and Montgomery's trick shares one
//   inversion across a batch at 3 products an element: 6 in all, plus the
//   batch's share of the tree and the inversion (6.1 an add at 2^20). The
//   wide levels run near the card's Fq product rate; the last few are
//   short, and there the block tree and the one inversion, a chain in one
//   thread while the SM waits, set the time.
// Design: the caller (ops/msm_pallas.land) sorts each window's (point,
//   digit) pairs by the unsigned 8-bit digit and keeps those of nonzero
//   digits (digit 0 is never added), bucket t = w * 256 + d - 1 at
//   first[0][t] .. first[0][t + 1]. Each bucket is summed by a pairwise tree
//   of affine adds: at level l, partials 2j and 2j + 1 of a bucket join into
//   partial j of level l + 1 (first[l + 1] counts them) and an odd last one
//   is carried over. One launch of `affine_level` a level: each warp takes
//   32 * `chunk` consecutive items of the level, lane j the items j, j + 32,
//   j + 64, ..., so a warp reads adjacent rows. Forward, it computes each
//   item's denominator (x2 - x1, or 2 y1 when the points are equal) and
//   keeps the running product of its denominators in the item's output row;
//   the block's 512 running products are inverted together by a product
//   tree in shared memory around one binary extended-Euclid inversion
//   (field.cuh) in one thread; backward, each thread peels off its items'
//   inverses and writes the sums over the rows. An infinity input, P + (-P)
//   and the odd carry never enter a batch. The caller picks the levels
//   (land: while each thread still has several adds); the last level writes
//   XYZZ, and the shared reduction (curve.cuh) joins each bucket's remaining
//   partials with its pairwise XYZZ merge and folds the buckets by slices
//   and offset-doubling trees into the 32 window sums; `window_pairs` joins
//   them in 16 pairs and the Horner ladder runs over those (c = 16): K4
//   returns the MSM as one XYZZ point, as K3 does.
// Measured on an H100 (scripts/k3_variants.py, K4 at 2^20): the levels
//   took 19.8 ms against the lane scan's 25.9; the binary inversion 21.9 ms
//   against 31.4 with Fermat's chain (zk_pow, 377 dependent squarings) and
//   20.6 with no inversion at all; one 512-thread block an SM 19.8 ms
//   against 20.3 with two of 256 and 21.4 with four of 128 (2^16 threads a
//   level each); the pairs took the ladder from 3.0 to 2.2 ms.
#include "curve.cuh"

namespace {

// threads of an affine_level block: one block an SM at 128 registers, with
// 48 KB of shared memory for its product tree
constexpr int LEVEL_BLOCK = 512;
constexpr int AW = 2 * L;          // words of one affine partial

// what an item of a level does with its two inputs
enum Kind : uint32_t {
  COPY_FIRST = 0,    // no second input (the odd carry), or it is infinity
  COPY_SECOND = 1,   // the first input is infinity
  ADD = 2,           // x1 != x2: denominator x2 - x1
  DBL = 3,           // P + P: denominator 2 y1
  CANCEL = 4,        // P + (-P), or P + P with y = 0: infinity
};

// the bucket b of item v: first[b] <= v < first[b + 1]
ZK_DEV int bucket_of(const long long* __restrict__ first, int n_buckets,
                     long long v) {
  int lo = 0, hi = n_buckets;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(first + mid) <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the row of src that holds input k of a level: sorted pair k's point
// through idx at level 0, else row k
ZK_DEV uint32_t level_row(const int* idx, long long k) {
  return idx ? (uint32_t)__ldg(idx + k) : (uint32_t)k;
}

// one coordinate (12 words) through the read-only path as 3 16-byte loads
ZK_DEV void load_coord(uint32_t* c, const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 a = __ldg(v + k);
    c[4 * k] = a.x;
    c[4 * k + 1] = a.y;
    c[4 * k + 2] = a.z;
    c[4 * k + 3] = a.w;
  }
}

// an affine input with x = 0 is infinity when y = 0 too
ZK_DEV bool finite(const uint32_t* x, const uint32_t* pt) {
  if (!zk_is_zero<Fq>(x)) return true;
  uint32_t y[L];
  load_coord(y, pt + L);
  return !zk_is_zero<Fq>(y);
}

ZK_DEV bool fq_equal(const uint32_t* a, const uint32_t* b) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) acc |= a[j] ^ b[j];
  return acc == 0;
}

// one output row: affine (x, y), or XYZZ (x, y, 1, 1) with infinity
// (x = y = 0) as ZZ = ZZZ = 0
ZK_DEV void store_partial(uint32_t* row, const uint32_t* x, const uint32_t* y,
                          bool xyzz) {
  zk_store_v<L>(row, x);
  zk_store_v<L>(row + L, y);
  if (xyzz) {
    const bool inf = zk_is_zero<Fq>(x) && zk_is_zero<Fq>(y);
    uint32_t one[L];
#pragma unroll
    for (int j = 0; j < L; ++j) one[j] = inf ? 0u : ZK_FQ_ONE[j];
    zk_store_v<L>(row + 2 * L, one);
    zk_store_v<L>(row + 3 * L, one);
  }
}

// One level of the pairwise tree. src: the level's inputs ([N, 2, 12]
// points read through idx at level 0, else [*, 2, 12] affine rows);
// first_in / first_out: [n_buckets + 1] offsets of each bucket's inputs and
// outputs; items = first_out[n_buckets]; the grid's threads times chunk
// cover the items; dst: [items, 2, 12] affine, or
// [items, 4, 12] XYZZ when xyzz. Until the backward pass overwrites it, an
// item's row holds the running product before it (words 0-11), the rows of
// src that hold its two inputs (12-13) and its Kind (14), written and read
// back by the same thread as 16-byte vectors.
__global__ void __launch_bounds__(LEVEL_BLOCK, 1)
affine_level(const uint32_t* __restrict__ src, const int* __restrict__ idx,
             const long long* __restrict__ first_in,
             const long long* __restrict__ first_out, int n_buckets,
             long long items, int chunk, int xyzz,
             uint32_t* __restrict__ dst) {
  __shared__ uint32_t tree[2 * LEVEL_BLOCK][L];
  const int tid = threadIdx.x;
  const long long g = (long long)blockIdx.x * LEVEL_BLOCK + tid;
  const int width = xyzz ? PW : AW;
  uint32_t acc[L];
  zk_load<L>(acc, ZK_FQ_ONE);
  // warp w takes items w * 32 * chunk + 32 c + lane: a warp's lanes read
  // adjacent rows, and a lane walks its buckets forward from one search
  const long long base = (g >> 5) * 32 * chunk + (tid & 31);
  int b = -1;
  // forward: classify each item, multiply up the denominators
  for (int c = 0; c < chunk; ++c) {
    const long long v = base + 32 * c;
    if (v >= items) break;
    if (b < 0) {
      b = bucket_of(first_out, n_buckets, v);
    } else {
      while (__ldg(first_out + b + 1) <= v) ++b;
    }
    const long long s = __ldg(first_in + b) + 2 * (v - __ldg(first_out + b));
    const uint32_t r1 = level_row(idx, s);
    uint32_t r2 = r1;
    uint32_t kind = COPY_FIRST;
    uint32_t den[L];
    if (s + 1 < __ldg(first_in + b + 1)) {
      // the x coordinates decide; a y is read only for x = 0 or x1 = x2
      r2 = level_row(idx, s + 1);
      const uint32_t* p1 = src + (long long)r1 * AW;
      const uint32_t* p2 = src + (long long)r2 * AW;
      uint32_t x1[L], x2[L];
      load_coord(x1, p1);
      load_coord(x2, p2);
      if (!finite(x1, p1)) {
        kind = COPY_SECOND;
      } else if (finite(x2, p2)) {
        fq_sub(den, x2, x1);
        if (!zk_is_zero<Fq>(den)) {
          kind = ADD;
        } else {
          uint32_t y1[L], y2[L];
          load_coord(y1, p1 + L);
          load_coord(y2, p2 + L);
          if (fq_equal(y1, y2) && !zk_is_zero<Fq>(y1)) {
            kind = DBL;
            fq_add(den, y1, y1);
          } else {
            kind = CANCEL;
          }
        }
      }
    }
    uint32_t* row = dst + v * width;
    if (kind == ADD || kind == DBL) {
      zk_store_v<L>(row, acc);
      fq_mul(acc, acc, den);
    }
    reinterpret_cast<uint4*>(row)[3] = make_uint4(r1, r2, kind, 0u);
  }
  // the block's product tree: leaf LEVEL_BLOCK + t is thread t's product,
  // node k the product of nodes 2k and 2k + 1, the root node 1
  zk_store<L>(tree[LEVEL_BLOCK + tid], acc);
  for (int w = LEVEL_BLOCK / 2; w >= 1; w >>= 1) {
    __syncthreads();
    if (tid < w) {
      const int k = w + tid;
      uint32_t a[L], b[L];
      zk_load<L>(a, tree[2 * k]);
      zk_load<L>(b, tree[2 * k + 1]);
      fq_mul(a, a, b);
      zk_store<L>(tree[k], a);
    }
  }
  __syncthreads();
  if (tid == 0) {
    // the root is a product of nonzero elements; its plain inverse times
    // R^3 (one Montgomery product) is its Montgomery inverse
    uint32_t r[L];
    zk_load<L>(r, tree[1]);
    zk_inv_binary<Fq>(r, r);
    fq_mul(r, r, ZK_FQ_R3);
    zk_store<L>(tree[1], r);
  }
  // down the tree: node k holds the inverse of its product, so its left
  // child's inverse is it times the right child's product, and the other way
  for (int w = 1; w < LEVEL_BLOCK; w <<= 1) {
    __syncthreads();
    if (tid < w) {
      const int k = w + tid;
      uint32_t inv[L], a[L], b[L];
      zk_load<L>(inv, tree[k]);
      zk_load<L>(a, tree[2 * k]);
      zk_load<L>(b, tree[2 * k + 1]);
      fq_mul(b, inv, b);
      fq_mul(a, inv, a);
      zk_store<L>(tree[2 * k], b);
      zk_store<L>(tree[2 * k + 1], a);
    }
  }
  __syncthreads();
  uint32_t inv[L];
  zk_load<L>(inv, tree[LEVEL_BLOCK + tid]);
  // backward: inv is the inverse of the product of the items before the
  // current one, times its own denominator
  for (int c = chunk - 1; c >= 0; --c) {
    const long long v = base + 32 * c;
    if (v >= items) continue;
    uint32_t* row = dst + v * width;
    const uint4 tag = reinterpret_cast<const uint4*>(row)[3];
    const uint32_t kind = tag.z;
    uint32_t x1[L], y1[L], x2[L], y2[L];
    load_affine(x1, y1, src + (long long)tag.x * AW);
    if (kind == COPY_FIRST) {
      store_partial(row, x1, y1, xyzz);
      continue;
    }
    load_affine(x2, y2, src + (long long)tag.y * AW);
    if (kind == COPY_SECOND) {
      store_partial(row, x2, y2, xyzz);
      continue;
    }
    if (kind == CANCEL) {
#pragma unroll
      for (int j = 0; j < L; ++j) x1[j] = 0;
      store_partial(row, x1, x1, xyzz);
      continue;
    }
    uint32_t pre[L], den[L], num[L];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 a = reinterpret_cast<const uint4*>(row)[k];
      pre[4 * k] = a.x;
      pre[4 * k + 1] = a.y;
      pre[4 * k + 2] = a.z;
      pre[4 * k + 3] = a.w;
    }
    if (kind == ADD) {
      fq_sub(den, x2, x1);
      fq_sub(num, y2, y1);
    } else {
      fq_add(den, y1, y1);
      fq_mul(num, x1, x1);
      fq_add(y2, num, num);
      fq_add(num, y2, num);              // 3 x1^2
    }
    fq_mul(pre, inv, pre);               // 1 / den
    fq_mul(inv, inv, den);
    fq_mul(num, num, pre);               // lambda
    fq_mul(den, num, num);
    fq_sub(den, den, x1);
    fq_sub(den, den, x2);                // x3 = lambda^2 - x1 - x2
    fq_sub(x2, x1, den);
    fq_mul(x2, num, x2);
    fq_sub(y2, x2, y1);                  // y3 = lambda (x1 - x3) - y1
    store_partial(row, den, y2, xyzz);
  }
}

// Window pair k of 16: S_2k + 2^8 S_2k+1 (one warp, the doublings spread
// over its lanes as in window_ladder), so that the ladder runs 16 windows
// of 16 bits: 15 x 16 doublings and 16 adds in sequence where 32 windows
// of 8 bits take 31 x 8 and 32. Lane 0 writes the pair.
__global__ void __launch_bounds__(32)
window_pairs(const uint32_t* __restrict__ window_sums,
             uint32_t* __restrict__ pairs) {
  const int k = blockIdx.x;
  Xyzz a, t;
  load_pt(a, window_sums + (2LL * k + 1) * PW);
  for (int e = 0; e < 8; ++e) xyzz_dbl_warp(a);
  load_pt(t, window_sums + 2LL * k * PW);
  xyzz_add<false>(a, t);
  if (threadIdx.x == 0) store_pt(pairs + (long long)k * PW, a);
}

}  // namespace

// Runs the affine levels and the reduction on `stream` for one group of
// `windows` windows. points: [N, 2, 12] affine Montgomery (x = y = 0 for
// infinity); idx: [P] int32 point index of each sorted pair of a nonzero
// digit; first: [levels + 1, W*256 + 1] int64 offsets of each bucket's
// partials at each level (row 0: its pairs; w the group's own window
// index); geometry: HOST [levels, 3] int64 (items, chunk, threads) of each
// level; buf0, buf1: affine scratch of at least items(0) and items(1) rows
// (levels 0, 2, ... and 1, 3, ... but the last write there); partial:
// [max(1, items(levels - 1)), 4, 12] XYZZ; merge_prefix, merge_passes,
// block_sums, counters (zeroed) as reduce_windows takes them over the last
// row of first; window_sums: the group's [windows, 4, 12] rows of the MSM's
// window sums. When ladder_windows > 0 (the last group), the window pairs
// and the ladder then run over all_sums, the MSM's [ladder_windows, 4, 12]
// window sums (block_sums must then hold ladder_windows / 2 rows), into
// out: the MSM as one XYZZ point [4, 12] in Montgomery form. A single
// group is the whole MSM: window_sums = all_sums, ladder_windows = windows.
extern "C" int zk_msm_u8(const void* points, const void* idx, const void* first,
                         int windows, int levels, const void* geometry,
                         void* buf0, void* buf1, void* partial,
                         const void* merge_prefix, int merge_passes,
                         int slice_log, int block_log, void* block_sums,
                         void* window_sums, void* counters,
                         const void* all_sums, int ladder_windows, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int buckets = 256;
  const int nb = windows * buckets;
  const long long* geo = (const long long*)geometry;
  const long long* fst = (const long long*)first;
  const uint32_t* src = (const uint32_t*)points;
  long long n_partial = 0;
  for (int l = 0; l < levels; ++l) {
    const bool last = l == levels - 1;
    uint32_t* dst = (uint32_t*)(last ? partial : (l % 2 ? buf1 : buf0));
    const long long items = geo[3 * l], threads = geo[3 * l + 2];
    affine_level<<<(unsigned)(threads / LEVEL_BLOCK), LEVEL_BLOCK, 0, s>>>(
        src, l == 0 ? (const int*)idx : nullptr, fst + (long long)l * (nb + 1),
        fst + (long long)(l + 1) * (nb + 1), nb, items, (int)geo[3 * l + 1],
        last, dst);
    int err = (int)cudaGetLastError();
    if (err) return err;
    src = dst;
    n_partial = items;
  }
  int err = reduce_windows(partial, merge_prefix, n_partial,
                           fst + (long long)levels * (nb + 1), merge_passes,
                           windows, buckets, slice_log, block_log, block_sums,
                           window_sums, counters, s);
  if (err || ladder_windows <= 0) return err;
  // the window pairs go to block_sums, which bucket_reduce is done with
  window_pairs<<<ladder_windows / 2, 32, 0, s>>>((const uint32_t*)all_sums,
                                                 (uint32_t*)block_sums);
  err = (int)cudaGetLastError();
  if (err) return err;
  window_ladder<<<1, 32, 0, s>>>((const uint32_t*)block_sums,
                                 ladder_windows / 2, 16, (uint32_t*)out);
  return (int)cudaGetLastError();
}
