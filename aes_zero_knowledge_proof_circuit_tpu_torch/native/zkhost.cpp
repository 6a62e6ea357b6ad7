// zkhost — native (C++) host-side BLS12-377 G1 arithmetic for the TPU ZK
// stack.
//
// The reference gets this tier from arkworks' native Rust (ark-ec Pippenger
// MSM / ark-ff Montgomery arithmetic; SURVEY.md §2b, Cargo.lock:76,118,159).
// Our device path runs MSMs in Pallas/XLA (ops/msm_jax.py); this library is
// the host-side runtime equivalent: SRS setup, hiding-commitment MSMs, the
// verifier's G1 folds, and the bit-exact oracle for kernel tests — all of
// which would otherwise run on Python bigints.
//
// C ABI only (consumed via ctypes, aes_zero_knowledge_proof_circuit_tpu/
// native/__init__.py). Representations at the boundary are canonical
// little-endian u64 limbs: Fq = 6 limbs, Fr scalars = 4 limbs. Points are
// affine (x, y, infinity flag) in, Jacobian (X, Y, Z) out.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 zkhost.cpp -o libzkhost.so

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Fq: 377-bit prime field, 6x64-bit limbs, Montgomery form (R = 2^384)
// ---------------------------------------------------------------------------

static const u64 Q[6] = {
    0x8508c00000000001ULL, 0x170b5d4430000000ULL, 0x1ef3622fba094800ULL,
    0x1a22d9f300f5138fULL, 0xc63b05c06ca1493bULL, 0x01ae3a4617c510eaULL};
static const u64 R2Q[6] = {
    0xb786686c9400cd22ULL, 0x0329fcaab00431b1ULL, 0x22a5f11162d6b46dULL,
    0xbfdf7d03827dc3acULL, 0x837e92f041790bf9ULL, 0x006dfccb1e914b88ULL};
static const u64 QINV = 0x8508bfffffffffffULL;  // -q^{-1} mod 2^64
static const u64 ONEQ[6] = {
    0x02cdffffffffff68ULL, 0x51409f837fffffb1ULL, 0x9f7db3a98a7d3ff2ULL,
    0x7b4e97b76e7c6305ULL, 0x4cf495bf803c84e8ULL, 0x008d6661e2fdf49aULL};

struct Fq {
  u64 v[6];
};

static inline bool fq_is_zero(const Fq &a) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.v[i];
  return acc == 0;
}

static inline int fq_cmp_q(const Fq &a) {  // a vs Q: -1,<; 0,==; 1,>
  for (int i = 5; i >= 0; i--) {
    if (a.v[i] < Q[i]) return -1;
    if (a.v[i] > Q[i]) return 1;
  }
  return 0;
}

static inline void fq_sub_q(Fq &a) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.v[i] - Q[i] - borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline Fq fq_add(const Fq &a, const Fq &b) {
  Fq r;
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = s >> 64;
  }
  // 377-bit values in 384-bit container: a+b < 2^378, no limb overflow loss
  if (carry || fq_cmp_q(r) >= 0) fq_sub_q(r);
  return r;
}

static inline Fq fq_sub(const Fq &a, const Fq &b) {
  Fq r;
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
      u128 s = (u128)r.v[i] + Q[i] + carry;
      r.v[i] = (u64)s;
      carry = s >> 64;
    }
  }
  return r;
}

// CIOS Montgomery multiplication, 6 limbs.
static Fq fq_mul(const Fq &a, const Fq &b) {
  u64 t[8] = {0};
  for (int i = 0; i < 6; i++) {
    u128 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < 6; j++) {
      u128 cur = (u128)t[j] + (u128)ai * b.v[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[6] + carry;
    t[6] = (u64)cur;
    t[7] = (u64)(cur >> 64);

    u64 m = t[0] * QINV;
    carry = ((u128)t[0] + (u128)m * Q[0]) >> 64;
    for (int j = 1; j < 6; j++) {
      u128 c2 = (u128)t[j] + (u128)m * Q[j] + carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    cur = (u128)t[6] + carry;
    t[5] = (u64)cur;
    t[6] = t[7] + (u64)(cur >> 64);
    t[7] = 0;
  }
  Fq r;
  memcpy(r.v, t, sizeof(r.v));
  if (t[6] || fq_cmp_q(r) >= 0) fq_sub_q(r);
  return r;
}

static inline Fq fq_sqr(const Fq &a) { return fq_mul(a, a); }

static Fq fq_pow(const Fq &a, const u64 *e, int nlimbs) {
  Fq acc;
  memcpy(acc.v, ONEQ, sizeof(acc.v));
  bool started = false;
  for (int i = nlimbs - 1; i >= 0; i--) {
    for (int b = 63; b >= 0; b--) {
      if (started) acc = fq_sqr(acc);
      if ((e[i] >> b) & 1) {
        if (started)
          acc = fq_mul(acc, a);
        else {
          acc = a;
          started = true;
        }
      }
    }
  }
  return acc;
}

static Fq fq_inv(const Fq &a) {  // Fermat: a^(q-2)
  u64 e[6];
  memcpy(e, Q, sizeof(e));
  // Q - 2 (Q[0] low limb ends in ...0001, so two borrows never propagate far)
  u128 borrow = 2;
  for (int i = 0; i < 6 && borrow; i++) {
    u128 d = (u128)e[i] - borrow;
    e[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  return fq_pow(a, e, 6);
}

static inline Fq fq_from_canonical(const u64 *limbs) {
  Fq a;
  memcpy(a.v, limbs, sizeof(a.v));
  Fq r2;
  memcpy(r2.v, R2Q, sizeof(r2.v));
  return fq_mul(a, r2);
}

static inline void fq_to_canonical(const Fq &a, u64 *out) {
  Fq one = {{1, 0, 0, 0, 0, 0}};
  Fq r = fq_mul(a, one);  // *R^{-1}
  memcpy(out, r.v, 6 * sizeof(u64));
}

// ---------------------------------------------------------------------------
// G1 (BLS12-377: y^2 = x^3 + 1, a = 0), Jacobian coordinates in Montgomery Fq
// ---------------------------------------------------------------------------

struct G1 {
  Fq x, y, z;  // z == 0 -> infinity
};

static inline G1 g1_infinity() {
  G1 p;
  memset(&p, 0, sizeof(p));
  memcpy(p.x.v, ONEQ, sizeof(p.x.v));
  memcpy(p.y.v, ONEQ, sizeof(p.y.v));
  return p;
}

static inline bool g1_is_inf(const G1 &p) { return fq_is_zero(p.z); }

// dbl-2009-l
static G1 g1_double(const G1 &p) {
  if (g1_is_inf(p)) return p;
  Fq a = fq_sqr(p.x);
  Fq b = fq_sqr(p.y);
  Fq c = fq_sqr(b);
  Fq t = fq_sub(fq_sqr(fq_add(p.x, b)), fq_add(a, c));
  Fq d = fq_add(t, t);
  Fq e = fq_add(fq_add(a, a), a);
  Fq f = fq_sqr(e);
  G1 r;
  r.x = fq_sub(f, fq_add(d, d));
  Fq c8 = fq_add(c, c);
  c8 = fq_add(c8, c8);
  c8 = fq_add(c8, c8);
  r.y = fq_sub(fq_mul(e, fq_sub(d, r.x)), c8);
  Fq yz = fq_mul(p.y, p.z);
  r.z = fq_add(yz, yz);
  return r;
}

// add-2007-bl
static G1 g1_add(const G1 &p, const G1 &q) {
  if (g1_is_inf(p)) return q;
  if (g1_is_inf(q)) return p;
  Fq z1z1 = fq_sqr(p.z);
  Fq z2z2 = fq_sqr(q.z);
  Fq u1 = fq_mul(p.x, z2z2);
  Fq u2 = fq_mul(q.x, z1z1);
  Fq s1 = fq_mul(fq_mul(p.y, q.z), z2z2);
  Fq s2 = fq_mul(fq_mul(q.y, p.z), z1z1);
  Fq h = fq_sub(u2, u1);
  Fq rr = fq_sub(s2, s1);
  if (fq_is_zero(h)) {
    if (fq_is_zero(rr)) return g1_double(p);
    return g1_infinity();
  }
  Fq i = fq_sqr(fq_add(h, h));
  Fq j = fq_mul(h, i);
  Fq r2 = fq_add(rr, rr);
  Fq v = fq_mul(u1, i);
  G1 out;
  out.x = fq_sub(fq_sub(fq_sqr(r2), j), fq_add(v, v));
  Fq s1j = fq_mul(s1, j);
  out.y = fq_sub(fq_mul(r2, fq_sub(v, out.x)), fq_add(s1j, s1j));
  out.z = fq_mul(fq_sub(fq_sqr(fq_add(p.z, q.z)), fq_add(z1z1, z2z2)), h);
  return out;
}

// mixed add (q affine: z == 1 in Montgomery form), madd-2007-bl
static G1 g1_add_affine(const G1 &p, const Fq &qx, const Fq &qy) {
  if (g1_is_inf(p)) {
    G1 r;
    r.x = qx;
    r.y = qy;
    memcpy(r.z.v, ONEQ, sizeof(r.z.v));
    return r;
  }
  Fq z1z1 = fq_sqr(p.z);
  Fq u2 = fq_mul(qx, z1z1);
  Fq s2 = fq_mul(fq_mul(qy, p.z), z1z1);
  Fq h = fq_sub(u2, p.x);
  Fq rr = fq_sub(s2, p.y);
  if (fq_is_zero(h)) {
    if (fq_is_zero(rr)) return g1_double(p);
    return g1_infinity();
  }
  Fq hh = fq_sqr(h);
  Fq i = fq_add(hh, hh);
  i = fq_add(i, i);
  Fq j = fq_mul(h, i);
  Fq r2 = fq_add(rr, rr);
  Fq v = fq_mul(p.x, i);
  G1 out;
  out.x = fq_sub(fq_sub(fq_sqr(r2), j), fq_add(v, v));
  Fq yj = fq_mul(p.y, j);
  out.y = fq_sub(fq_mul(r2, fq_sub(v, out.x)), fq_add(yj, yj));
  out.z = fq_sub(fq_sub(fq_sqr(fq_add(p.z, h)), z1z1), hh);
  return out;
}

static inline Fq fq_neg(const Fq &a) {
  if (fq_is_zero(a)) return a;
  Fq r;
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)Q[i] - a.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  return r;
}

// ---------------------------------------------------------------------------
// Pippenger MSM
// ---------------------------------------------------------------------------

static int window_bits(size_t n) {
  if (n < 32) return 3;
  int c = 1;
  while ((size_t)1 << (c + 2) < n && c < 16) c++;
  return c + 2 > 16 ? 16 : c + 2;
}

// Window size for the signed-digit batch-affine MSM. Measured on the
// 2-core Xeon host (2^18 and 2^20 inputs): larger windows win well past
// the naive mul-count model because shallow buckets mean few collision-
// deferral passes; c=16 and c=17 are within noise at 2^20 while c<=14
// loses ~40%. Rule: c = floor(log2 n) clamped to [6, 16] bits (so the
// signed-bucket count 2^(c-1) ~ n/2); tiny inputs (n < 64) use c = 4.
static int window_bits_signed(size_t n) {
  if (n < 64) return 4;
  int lg = 0;
  while ((size_t)1 << (lg + 1) <= n) lg++;
  int c = lg;
  if (c < 6) c = 6;
  if (c > 16) c = 16;
  return c;
}

extern "C" {

// points: n * 12 u64 (x limbs, y limbs), canonical; inf: n bytes (1 = point
// at infinity); scalars: n * 4 u64 canonical (< r < 2^253).
// out: 18 u64 Jacobian (X, Y, Z) canonical. Returns 0 on success.
int zk_g1_msm(const u64 *points, const uint8_t *inf, const u64 *scalars,
              size_t n, u64 *out) {
  const int SCALAR_BITS = 253;
  int c = window_bits(n);
  int nwin = (SCALAR_BITS + c - 1) / c;
  size_t nbuckets = ((size_t)1 << c) - 1;

  // convert points to Montgomery once
  std::vector<Fq> px(n), py(n);
  for (size_t i = 0; i < n; i++) {
    px[i] = fq_from_canonical(points + 12 * i);
    py[i] = fq_from_canonical(points + 12 * i + 6);
  }

  G1 total = g1_infinity();
  std::vector<G1> buckets(nbuckets);
  for (int w = nwin - 1; w >= 0; w--) {
    for (size_t b = 0; b < nbuckets; b++) buckets[b] = g1_infinity();
    int bit0 = w * c;
    for (size_t i = 0; i < n; i++) {
      if (inf && inf[i]) continue;
      // extract c bits starting at bit0 from the 4-limb scalar
      int limb = bit0 >> 6, off = bit0 & 63;
      u64 frag = scalars[4 * i + limb] >> off;
      if (off + c > 64 && limb + 1 < 4)
        frag |= scalars[4 * i + limb + 1] << (64 - off);
      frag &= ((u64)1 << c) - 1;
      if (frag) buckets[frag - 1] = g1_add_affine(buckets[frag - 1], px[i], py[i]);
    }
    // running-sum bucket reduction
    G1 running = g1_infinity(), windowsum = g1_infinity();
    for (size_t b = nbuckets; b-- > 0;) {
      running = g1_add(running, buckets[b]);
      windowsum = g1_add(windowsum, running);
    }
    if (w != nwin - 1)
      for (int k = 0; k < c; k++) total = g1_double(total);
    total = g1_add(total, windowsum);
  }

  fq_to_canonical(total.x, out);
  fq_to_canonical(total.y, out + 6);
  fq_to_canonical(g1_is_inf(total) ? Fq{{0, 0, 0, 0, 0, 0}} : total.z,
                  out + 12);
  return 0;
}

// Fixed-base powers: out[i] = scalars[i] * (x, y) for SRS generation.
// scalars: n * 4 u64; out: n * 13 u64 (x, y canonical affine + inf flag word).
int zk_g1_scale_base(const u64 *base_xy, const u64 *scalars, size_t n,
                     u64 *out) {
  Fq bx = fq_from_canonical(base_xy);
  Fq by = fq_from_canonical(base_xy + 6);
  for (size_t i = 0; i < n; i++) {
    G1 acc = g1_infinity();
    const u64 *s = scalars + 4 * i;
    bool started = false;
    for (int limb = 3; limb >= 0; limb--)
      for (int b = 63; b >= 0; b--) {
        if (started) acc = g1_double(acc);
        if ((s[limb] >> b) & 1) {
          acc = g1_add_affine(acc, bx, by);
          started = true;
        }
      }
    // to affine
    u64 *o = out + 13 * i;
    if (g1_is_inf(acc)) {
      memset(o, 0, 13 * sizeof(u64));
      o[12] = 1;
      continue;
    }
    Fq zinv = fq_inv(acc.z);
    Fq zinv2 = fq_sqr(zinv);
    Fq ax = fq_mul(acc.x, zinv2);
    Fq ay = fq_mul(acc.y, fq_mul(zinv2, zinv));
    fq_to_canonical(ax, o);
    fq_to_canonical(ay, o + 6);
    o[12] = 0;
  }
  return 0;
}

// Fixed-base powers via 8-bit window tables: out[i] = scalars[i] * base.
// Builds T[w][d] = d * 2^(8w) * base (32 x 256 affine entries, batch-
// normalized once), then each output point is <= 32 mixed adds. This is the
// SRS "powers of tau" generator (reference: KZG10::setup under
// generate_universal_srs, src/lib.rs:141).
// scalars: n * 4 u64; out: n * 13 u64 (x, y canonical + inf flag word).
int zk_g1_powers_fixed_base(const u64 *base_xy, const u64 *scalars, size_t n,
                            u64 *out) {
  const int W = 32, D = 256;
  Fq bx = fq_from_canonical(base_xy);
  Fq by = fq_from_canonical(base_xy + 6);

  // Jacobian tables
  std::vector<G1> jt((size_t)W * D);
  G1 base;
  base.x = bx;
  base.y = by;
  memcpy(base.z.v, ONEQ, sizeof(base.z.v));
  for (int w = 0; w < W; w++) {
    jt[(size_t)w * D] = g1_infinity();
    G1 acc = base;
    for (int d = 1; d < D; d++) {
      jt[(size_t)w * D + d] = acc;
      if (d + 1 < D) acc = g1_add(acc, base);
    }
    for (int k = 0; k < 8; k++) base = g1_double(base);
  }
  // batch-normalize tables to affine (one inversion)
  size_t nt = jt.size();
  std::vector<Fq> zs(nt), prefix(nt + 1);
  std::vector<char> tinf(nt);
  for (size_t i = 0; i < nt; i++) {
    tinf[i] = g1_is_inf(jt[i]);
    zs[i] = jt[i].z;
    if (tinf[i]) memcpy(zs[i].v, ONEQ, sizeof(zs[i].v));
  }
  memcpy(prefix[0].v, ONEQ, sizeof(prefix[0].v));
  for (size_t i = 0; i < nt; i++) prefix[i + 1] = fq_mul(prefix[i], zs[i]);
  Fq inv_all = fq_inv(prefix[nt]);
  std::vector<Fq> tx(nt), ty(nt);
  for (size_t i = nt; i-- > 0;) {
    Fq zinv = fq_mul(inv_all, prefix[i]);
    inv_all = fq_mul(inv_all, zs[i]);
    Fq zinv2 = fq_sqr(zinv);
    tx[i] = fq_mul(jt[i].x, zinv2);
    ty[i] = fq_mul(jt[i].y, fq_mul(zinv2, zinv));
  }

  // all points: gather-and-add per 8-bit digit; batch-normalize in blocks
  const size_t BLK = 4096;
  std::vector<G1> blkpts(BLK);
  std::vector<Fq> bz(BLK), bpre(BLK + 1);
  for (size_t s0 = 0; s0 < n; s0 += BLK) {
    size_t m = n - s0 < BLK ? n - s0 : BLK;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < m; i++) {
      const u64 *s = scalars + 4 * (s0 + i);
      G1 acc = g1_infinity();
      for (int w = 0; w < W; w++) {
        int d = (int)((s[w >> 3] >> ((w & 7) * 8)) & 0xFF);
        if (d && !tinf[(size_t)w * D + d])
          acc = g1_add_affine(acc, tx[(size_t)w * D + d],
                              ty[(size_t)w * D + d]);
      }
      blkpts[i] = acc;
    }
    // batch normalize the block
    for (size_t i = 0; i < m; i++) {
      bz[i] = blkpts[i].z;
      if (fq_is_zero(bz[i])) memcpy(bz[i].v, ONEQ, sizeof(bz[i].v));
    }
    memcpy(bpre[0].v, ONEQ, sizeof(bpre[0].v));
    for (size_t i = 0; i < m; i++) bpre[i + 1] = fq_mul(bpre[i], bz[i]);
    Fq binv = fq_inv(bpre[m]);
    for (size_t i = m; i-- > 0;) {
      Fq zinv = fq_mul(binv, bpre[i]);
      binv = fq_mul(binv, bz[i]);
      u64 *o = out + 13 * (s0 + i);
      if (g1_is_inf(blkpts[i])) {
        memset(o, 0, 13 * sizeof(u64));
        o[12] = 1;
        continue;
      }
      Fq zinv2 = fq_sqr(zinv);
      fq_to_canonical(fq_mul(blkpts[i].x, zinv2), o);
      fq_to_canonical(fq_mul(blkpts[i].y, fq_mul(zinv2, zinv)), o + 6);
      o[12] = 0;
    }
  }
  return 0;
}

// Batch Jacobian -> affine normalization (Montgomery batch inversion).
// in: n * 18 u64 canonical Jacobian; out: n * 13 u64 affine + inf flag.
int zk_g1_batch_normalize(const u64 *jac, size_t n, u64 *out) {
  std::vector<Fq> zs(n);
  std::vector<char> isinf(n);
  for (size_t i = 0; i < n; i++) {
    zs[i] = fq_from_canonical(jac + 18 * i + 12);
    isinf[i] = fq_is_zero(zs[i]);
    if (isinf[i]) memcpy(zs[i].v, ONEQ, sizeof(zs[i].v));
  }
  // prefix products
  std::vector<Fq> prefix(n + 1);
  memcpy(prefix[0].v, ONEQ, sizeof(prefix[0].v));
  for (size_t i = 0; i < n; i++) prefix[i + 1] = fq_mul(prefix[i], zs[i]);
  Fq inv_all = fq_inv(prefix[n]);
  for (size_t i = n; i-- > 0;) {
    Fq zinv = fq_mul(inv_all, prefix[i]);
    inv_all = fq_mul(inv_all, zs[i]);
    u64 *o = out + 13 * i;
    if (isinf[i]) {
      memset(o, 0, 13 * sizeof(u64));
      o[12] = 1;
      continue;
    }
    Fq x = fq_from_canonical(jac + 18 * i);
    Fq y = fq_from_canonical(jac + 18 * i + 6);
    Fq zinv2 = fq_sqr(zinv);
    fq_to_canonical(fq_mul(x, zinv2), o);
    fq_to_canonical(fq_mul(y, fq_mul(zinv2, zinv)), o + 6);
    o[12] = 0;
  }
  return 0;
}

// Pippenger MSM over 16-bit-limb packed affine points (the SRS checkpoint /
// device boundary layout: n * 2 * 24 u32 little-endian 16-bit limbs; all-
// zero rows = infinity). This is the prover's commit MSM entry (ark-ec
// VariableBaseMSM analog; SURVEY.md §2b) — ~90% of Marlin prove time flows
// through here, so it uses the two standard high-end Pippenger refinements:
//
//   * signed-digit windows: digits in [-2^(c-1), 2^(c-1)] halve the bucket
//     count (negation of an affine point is free: negate y);
//   * batch-affine bucket accumulation: buckets stay AFFINE and additions
//     complete with one shared Montgomery batch inversion per pass
//     (~6 fq_mul amortized per add vs ~16 for a Jacobian mixed add).
//     Same-bucket collisions within a pass are deferred to the next pass.
//
// Windows run under OpenMP. c = window bits (0 = auto).
int zk_g1_msm_limb16(const uint32_t *packed, const u64 *scalars, size_t n,
                     int c, u64 *out) {
  const int SCALAR_BITS = 253;
  if (c <= 0) c = window_bits_signed(n);
  // nwin raw windows + 1 for the signed-recode carry
  int nwin = (SCALAR_BITS + c - 1) / c + 1;
  size_t nb = (size_t)1 << (c - 1);  // buckets hold digits 1..2^(c-1)
  const int64_t half = (int64_t)1 << (c - 1);

  std::vector<Fq> px(n), py(n);
  std::vector<uint8_t> inf(n);
  // signed digits, window-major: dig[w*n + i]
  std::vector<int32_t> dig((size_t)nwin * n);
#pragma omp parallel for schedule(static)
  for (long i = 0; i < (long)n; i++) {
    const uint32_t *pp = packed + (size_t)i * 48;
    bool zero = true;
    for (int k = 0; k < 48 && zero; k++)
      if (pp[k]) zero = false;
    inf[i] = zero ? 1 : 0;
    if (!zero) {
      u64 limbs[12];
      for (int w = 0; w < 12; w++) {
        u64 v = 0;
        for (int t = 3; t >= 0; t--)
          v = (v << 16) | (u64)(pp[w * 4 + t] & 0xFFFF);
        limbs[w] = v;
      }
      px[i] = fq_from_canonical(limbs);
      py[i] = fq_from_canonical(limbs + 6);
    }
    // signed recode (even for infinity rows; they are skipped later)
    int64_t carry = 0;
    for (int w = 0; w < nwin; w++) {
      int bit0 = w * c;
      u64 frag = 0;
      if (bit0 < 256) {
        int limb = bit0 >> 6, off = bit0 & 63;
        frag = scalars[4 * i + limb] >> off;
        if (off + c > 64 && limb + 1 < 4)
          frag |= scalars[4 * i + limb + 1] << (64 - off);
        frag &= ((u64)1 << c) - 1;
      }
      int64_t v = (int64_t)frag + carry;
      if (v > half) {
        dig[(size_t)w * n + i] = (int32_t)(v - ((int64_t)1 << c));
        carry = 1;
      } else {
        dig[(size_t)w * n + i] = (int32_t)v;
        carry = 0;
      }
    }
  }

  std::vector<G1> winsums(nwin);
#pragma omp parallel for schedule(dynamic)
  for (int w = 0; w < nwin; w++) {
    const int32_t *dw = dig.data() + (size_t)w * n;
    std::vector<Fq> bx(nb), by(nb);
    std::vector<uint8_t> occ(nb, 0);
    std::vector<uint32_t> claimed(nb, 0);
    uint32_t epoch = 0;

    std::vector<uint32_t> cur, nxt, jobs;
    cur.reserve(n);
    for (size_t i = 0; i < n; i++)
      if (!inf[i] && dw[i]) cur.push_back((uint32_t)i);

    const size_t CH = 8192;
    std::vector<Fq> denom(CH), pre(CH + 1), x2s(CH), y2s(CH);
    std::vector<uint8_t> kind(CH);  // 0 = add, 1 = double, 2 = cancel
    while (!cur.empty()) {
      epoch++;
      jobs.clear();
      nxt.clear();
      for (uint32_t i : cur) {
        int32_t d = dw[i];
        uint32_t b = (uint32_t)(d > 0 ? d : -d) - 1;
        if (claimed[b] == epoch) {
          nxt.push_back(i);
          continue;
        }
        claimed[b] = epoch;
        if (!occ[b]) {
          bx[b] = px[i];
          by[b] = d > 0 ? py[i] : fq_neg(py[i]);
          occ[b] = 1;
        } else {
          jobs.push_back(i);
        }
      }
      // complete the claimed additions, one batch inversion per chunk
      for (size_t j0 = 0; j0 < jobs.size(); j0 += CH) {
        size_t m = jobs.size() - j0 < CH ? jobs.size() - j0 : CH;
        for (size_t j = 0; j < m; j++) {
          uint32_t i = jobs[j0 + j];
          int32_t d = dw[i];
          uint32_t b = (uint32_t)(d > 0 ? d : -d) - 1;
          Fq X2 = px[i];
          Fq Y2 = d > 0 ? py[i] : fq_neg(py[i]);
          x2s[j] = X2;
          y2s[j] = Y2;
          Fq dx = fq_sub(X2, bx[b]);
          if (fq_is_zero(dx)) {
            if (fq_is_zero(fq_sub(Y2, by[b]))) {  // double: m = 3x^2 / 2y
              kind[j] = 1;
              denom[j] = fq_add(by[b], by[b]);
            } else {  // P + (-P) = infinity
              kind[j] = 2;
              memcpy(denom[j].v, ONEQ, sizeof(denom[j].v));
            }
          } else {
            kind[j] = 0;
            denom[j] = dx;
          }
        }
        memcpy(pre[0].v, ONEQ, sizeof(pre[0].v));
        for (size_t j = 0; j < m; j++) pre[j + 1] = fq_mul(pre[j], denom[j]);
        Fq inv_all = fq_inv(pre[m]);
        for (size_t j = m; j-- > 0;) {
          Fq invd = fq_mul(inv_all, pre[j]);
          inv_all = fq_mul(inv_all, denom[j]);
          uint32_t i = jobs[j0 + j];
          int32_t d = dw[i];
          uint32_t b = (uint32_t)(d > 0 ? d : -d) - 1;
          if (kind[j] == 2) {
            occ[b] = 0;
            continue;
          }
          Fq slope;
          if (kind[j] == 1) {
            Fq x1sq = fq_sqr(bx[b]);
            slope = fq_mul(fq_add(fq_add(x1sq, x1sq), x1sq), invd);
          } else {
            slope = fq_mul(fq_sub(y2s[j], by[b]), invd);
          }
          Fq x3 = fq_sub(fq_sub(fq_sqr(slope), bx[b]), x2s[j]);
          Fq y3 = fq_sub(fq_mul(slope, fq_sub(bx[b], x3)), by[b]);
          bx[b] = x3;
          by[b] = y3;
        }
      }
      std::swap(cur, nxt);
    }

    // running-sum bucket reduction (buckets are affine -> mixed adds)
    G1 running = g1_infinity(), windowsum = g1_infinity();
    for (size_t b = nb; b-- > 0;) {
      if (occ[b]) running = g1_add_affine(running, bx[b], by[b]);
      windowsum = g1_add(windowsum, running);
    }
    winsums[w] = windowsum;
  }

  G1 total = g1_infinity();
  for (int w = nwin - 1; w >= 0; w--) {
    if (w != nwin - 1)
      for (int k = 0; k < c; k++) total = g1_double(total);
    total = g1_add(total, winsums[w]);
  }
  fq_to_canonical(total.x, out);
  fq_to_canonical(total.y, out + 6);
  fq_to_canonical(g1_is_inf(total) ? Fq{{0, 0, 0, 0, 0, 0}} : total.z,
                  out + 12);
  return 0;
}

int zk_version() { return 1; }

}  // extern "C"
