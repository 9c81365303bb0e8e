// Native host-side core: scalar/sequential hot paths of the framework.
//
// The accelerator owns all batch compute (JAX/XLA/Pallas); this library covers the
// host-side scalar work the reference implements in compiled Rust — single
// Tip5 permutations (proof verification, partial Merkle trees, MMR walks),
// small NTTs, polynomial long division, batch inversion — where Python-int
// arithmetic would dominate.
//
// Field: Goldilocks p = 2^64 - 2^32 + 1, canonical residues (no Montgomery
// form; see twenty_first_tpu/math/gf.py for the rationale). The Tip5 S-box
// is specified on Montgomery bytes, so the permutation converts to the
// Montgomery representative for the lookup only (reference semantics:
// twenty-first/src/tip5/mod.rs:197-207).
//
// C ABI only; consumed via ctypes from twenty_first_tpu/native.py.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>
#include <cstdlib>

using u64 = uint64_t;
using u128 = __uint128_t;

static constexpr u64 P = 0xffffffff00000001ULL;
static constexpr u64 EPSILON = 0xffffffffULL;  // 2^64 mod p

static inline u64 reduce128(u128 x) {
  u64 lo = (u64)x;
  u64 hi = (u64)(x >> 64);
  u64 hi_hi = hi >> 32;
  u64 hi_lo = hi & EPSILON;
  u64 t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPSILON;  // wrap correction
  u64 t1 = hi_lo * EPSILON;
  u64 res = t0 + t1;
  if (res < t0) res += EPSILON;  // wrap correction
  if (res >= P) res -= P;
  return res;
}

static inline u64 gl_mul(u64 a, u64 b) { return reduce128((u128)a * b); }

static inline u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  if (s < a) s += EPSILON;  // wrapped past 2^64
  if (s >= P) s -= P;
  return s;
}

static inline u64 gl_sub(u64 a, u64 b) {
  u64 d = a - b;
  if (a < b) d -= EPSILON;  // wrap correction: d - 2^64 + p
  return d;
}

static inline u64 gl_pow(u64 base, u64 e) {
  u64 acc = 1;
  while (e) {
    if (e & 1) acc = gl_mul(acc, base);
    base = gl_mul(base, base);
    e >>= 1;
  }
  return acc;
}

static inline u64 gl_inv(u64 x) { return gl_pow(x, P - 2); }

#if defined(__AVX512F__) && defined(__AVX512DQ__)
#include <immintrin.h>

#define TIP5_AVX512 1

static inline __m512i glv_reduce(__m512i lo, __m512i hi) {
  const __m512i eps = _mm512_set1_epi64((long long)EPSILON);
  const __m512i p = _mm512_set1_epi64((long long)P);
  const __m512i hihi = _mm512_srli_epi64(hi, 32);
  __m512i t0 = _mm512_sub_epi64(lo, hihi);
  const __mmask8 bw = _mm512_cmplt_epu64_mask(lo, hihi);
  t0 = _mm512_mask_sub_epi64(t0, bw, t0, eps);
  const __m512i t1 = _mm512_mul_epu32(hi, eps);  // low32(hi) * EPSILON
  __m512i res = _mm512_add_epi64(t0, t1);
  const __mmask8 ov = _mm512_cmplt_epu64_mask(res, t0);
  res = _mm512_mask_add_epi64(res, ov, res, eps);
  const __mmask8 ge = _mm512_cmpge_epu64_mask(res, p);
  return _mm512_mask_sub_epi64(res, ge, res, p);
}

static inline __m512i glv_mul(__m512i a, __m512i b) {
  const __m512i ah = _mm512_srli_epi64(a, 32);
  const __m512i bh = _mm512_srli_epi64(b, 32);
  const __m512i ll = _mm512_mul_epu32(a, b);  // vpmuludq reads low 32s
  const __m512i lh = _mm512_mul_epu32(a, bh);
  const __m512i hl = _mm512_mul_epu32(ah, b);
  const __m512i hh = _mm512_mul_epu32(ah, bh);
  const __m512i cross = _mm512_add_epi64(lh, hl);
  const __mmask8 cc = _mm512_cmplt_epu64_mask(cross, lh);
  const __m512i lo = _mm512_add_epi64(ll, _mm512_slli_epi64(cross, 32));
  const __mmask8 c0 = _mm512_cmplt_epu64_mask(lo, ll);
  __m512i hi = _mm512_add_epi64(hh, _mm512_srli_epi64(cross, 32));
  hi = _mm512_mask_add_epi64(hi, cc, hi,
                             _mm512_set1_epi64(1LL << 32));
  hi = _mm512_mask_add_epi64(hi, c0, hi, _mm512_set1_epi64(1));
  return glv_reduce(lo, hi);
}

static inline __m512i glv_add(__m512i a, __m512i b) {
  const __m512i eps = _mm512_set1_epi64((long long)EPSILON);
  const __m512i p = _mm512_set1_epi64((long long)P);
  __m512i s = _mm512_add_epi64(a, b);
  const __mmask8 c = _mm512_cmplt_epu64_mask(s, a);
  s = _mm512_mask_add_epi64(s, c, s, eps);
  const __mmask8 ge = _mm512_cmpge_epu64_mask(s, p);
  return _mm512_mask_sub_epi64(s, ge, s, p);
}


static inline __m512i glv_sub(__m512i a, __m512i b) {
  __m512i d = _mm512_sub_epi64(a, b);
  const __mmask8 bw = _mm512_cmplt_epu64_mask(a, b);
  return _mm512_mask_sub_epi64(d, bw, d,
                               _mm512_set1_epi64((long long)EPSILON));
}

static inline u64 glv_hsum_field(__m512i v) {
  // field-sum of the 8 lanes: log-tree of glv_add across shuffles
  __m512i s = glv_add(v, _mm512_shuffle_i64x2(v, v, 0x4E));  // 256 halves
  s = glv_add(s, _mm512_shuffle_i64x2(s, s, 0xB1));          // 128 chunks
  s = glv_add(s, _mm512_permutex_epi64(s, 0xB1));            // 64 pairs
  return (u64)_mm_cvtsi128_si64(_mm512_castsi512_si128(s));
}

#endif  // __AVX512F__ && __AVX512DQ__


extern "C" {

// ---------------------------------------------------------------------------
// Elementwise field ops on arrays
// ---------------------------------------------------------------------------

// Elementwise loops use the AVX-512 field primitives when available:
// gcc will not form vpmuludq from the scalar forms (see the Tip5 kernel
// note), and even add/sub gain from mask-register wrap corrections.

void gl_add_arrays(const u64* a, const u64* b, u64* out, size_t n) {
  size_t i = 0;
#ifdef TIP5_AVX512
  for (; i + 8 <= n; i += 8)
    _mm512_storeu_si512((void*)(out + i),
                        glv_add(_mm512_loadu_si512((const void*)(a + i)),
                                _mm512_loadu_si512((const void*)(b + i))));
#endif
  for (; i < n; i++) out[i] = gl_add(a[i], b[i]);
}

void gl_sub_arrays(const u64* a, const u64* b, u64* out, size_t n) {
  size_t i = 0;
#ifdef TIP5_AVX512
  for (; i + 8 <= n; i += 8)
    _mm512_storeu_si512((void*)(out + i),
                        glv_sub(_mm512_loadu_si512((const void*)(a + i)),
                                _mm512_loadu_si512((const void*)(b + i))));
#endif
  for (; i < n; i++) out[i] = gl_sub(a[i], b[i]);
}

void gl_mul_arrays(const u64* a, const u64* b, u64* out, size_t n) {
  size_t i = 0;
#ifdef TIP5_AVX512
  for (; i + 8 <= n; i += 8)
    _mm512_storeu_si512((void*)(out + i),
                        glv_mul(_mm512_loadu_si512((const void*)(a + i)),
                                _mm512_loadu_si512((const void*)(b + i))));
#endif
  for (; i < n; i++) out[i] = gl_mul(a[i], b[i]);
}

// Extension-field multiply on interleaved (n, 3) arrays: the reference's
// explicit Shah-polynomial reduction (x_field_element.rs:512-535):
//   r0 = s0*o0 - s2*o1 - s1*o2
//   r1 = s1*o0 + s0*o1 + s2*o1 + (s1 - s2)*o2
//   r2 = s2*o0 + s1*o1 + (s0 + s2)*o2
#ifdef TIP5_AVX512
// Deinterleave 8 interleaved (s0,s1,s2) triples (3 zmm) into planar
// vectors with two vpermi2q per plane, and back. setr = low-to-high.
static inline void xfe_deint(const u64* p, __m512i* v0, __m512i* v1,
                             __m512i* v2) {
  const __m512i z0 = _mm512_loadu_si512((const void*)(p + 0));
  const __m512i z1 = _mm512_loadu_si512((const void*)(p + 8));
  const __m512i z2 = _mm512_loadu_si512((const void*)(p + 16));
  const __m512i i0a = _mm512_setr_epi64(0, 3, 6, 9, 12, 15, 0, 0);
  const __m512i i0b = _mm512_setr_epi64(0, 1, 2, 3, 4, 5, 10, 13);
  const __m512i i1a = _mm512_setr_epi64(1, 4, 7, 10, 13, 0, 0, 0);
  const __m512i i1b = _mm512_setr_epi64(0, 1, 2, 3, 4, 8, 11, 14);
  const __m512i i2a = _mm512_setr_epi64(2, 5, 8, 11, 14, 0, 0, 0);
  const __m512i i2b = _mm512_setr_epi64(0, 1, 2, 3, 4, 9, 12, 15);
  *v0 = _mm512_permutex2var_epi64(_mm512_permutex2var_epi64(z0, i0a, z1),
                                  i0b, z2);
  *v1 = _mm512_permutex2var_epi64(_mm512_permutex2var_epi64(z0, i1a, z1),
                                  i1b, z2);
  *v2 = _mm512_permutex2var_epi64(_mm512_permutex2var_epi64(z0, i2a, z1),
                                  i2b, z2);
}

static inline void xfe_int(__m512i r0, __m512i r1, __m512i r2, u64* p) {
  // out flat lane k holds plane k%3, element k/3
  const __m512i a0 = _mm512_setr_epi64(0, 8, 0, 1, 9, 0, 2, 10);
  const __m512i b0 = _mm512_setr_epi64(0, 1, 8, 3, 4, 9, 6, 7);
  const __m512i a1 = _mm512_setr_epi64(0, 3, 11, 0, 4, 12, 0, 5);
  const __m512i b1 = _mm512_setr_epi64(10, 1, 2, 11, 4, 5, 12, 7);
  const __m512i a2 = _mm512_setr_epi64(13, 0, 6, 14, 0, 7, 15, 0);
  const __m512i b2 = _mm512_setr_epi64(0, 13, 2, 3, 14, 5, 6, 15);
  _mm512_storeu_si512((void*)(p + 0),
      _mm512_permutex2var_epi64(_mm512_permutex2var_epi64(r0, a0, r1),
                                b0, r2));
  _mm512_storeu_si512((void*)(p + 8),
      _mm512_permutex2var_epi64(_mm512_permutex2var_epi64(r0, a1, r1),
                                b1, r2));
  _mm512_storeu_si512((void*)(p + 16),
      _mm512_permutex2var_epi64(_mm512_permutex2var_epi64(r0, a2, r1),
                                b2, r2));
}
#endif  // TIP5_AVX512

void gl_xfe_mul_arrays(const u64* a, const u64* b, u64* out, size_t n) {
  size_t i = 0;
#ifdef TIP5_AVX512
  for (; i + 8 <= n; i += 8) {
    __m512i s0, s1, s2, o0, o1, o2;
    xfe_deint(a + 3 * i, &s0, &s1, &s2);
    xfe_deint(b + 3 * i, &o0, &o1, &o2);
    const __m512i s2o1 = glv_mul(s2, o1);
    const __m512i r0 = glv_sub(glv_mul(s0, o0),
                               glv_add(s2o1, glv_mul(s1, o2)));
    __m512i r1 = glv_add(glv_mul(s1, o0), glv_mul(s0, o1));
    r1 = glv_add(r1, s2o1);
    r1 = glv_add(r1, glv_mul(glv_sub(s1, s2), o2));
    __m512i r2 = glv_add(glv_mul(s2, o0), glv_mul(s1, o1));
    r2 = glv_add(r2, glv_mul(glv_add(s0, s2), o2));
    xfe_int(r0, r1, r2, out + 3 * i);
  }
#endif
  for (; i < n; i++) {
    const u64 s0 = a[3 * i], s1 = a[3 * i + 1], s2 = a[3 * i + 2];
    const u64 o0 = b[3 * i], o1 = b[3 * i + 1], o2 = b[3 * i + 2];
    out[3 * i] = gl_sub(gl_mul(s0, o0),
                        gl_add(gl_mul(s2, o1), gl_mul(s1, o2)));
    u64 r1 = gl_add(gl_mul(s1, o0), gl_mul(s0, o1));
    r1 = gl_add(r1, gl_mul(s2, o1));
    out[3 * i + 1] = gl_add(r1, gl_mul(gl_sub(s1, s2), o2));
    u64 r2 = gl_add(gl_mul(s2, o0), gl_mul(s1, o1));
    out[3 * i + 2] = gl_add(r2, gl_mul(gl_add(s0, s2), o2));
  }
}

void gl_batch_inverse(const u64* in, u64* out, size_t n);

// Zerofier-based O(n^2) Lagrange interpolation (polynomial.rs:1565-1607
// semantics): out[0..n) = coefficients of the unique degree-<n polynomial
// through (dom[i], vals[i]). Caller guarantees distinct domain points.
void gl_lagrange_interpolate(const u64* dom, const u64* vals, size_t n,
                             u64* out) {
  if (n == 0) return;
  // zerofier z = prod_i (x - dom[i]), degree n. Incremental update
  // z_new[j] = z_old[j-1] - d*z_old[j], processed top-down so the
  // shifted read never sees a written value; the inner sweep runs 8
  // coefficients per AVX-512 step.
  std::vector<u64> z(n + 1, 0);
  z[0] = 1;
  for (size_t i = 0; i < n; i++) {
    const u64 d = dom[i];
    size_t j = i + 1;
#ifdef TIP5_AVX512
    const __m512i dv = _mm512_set1_epi64((long long)d);
    for (; j >= 8; j -= 8) {
      const size_t base = j - 7;
      const __m512i cur =
          _mm512_loadu_si512((const void*)(z.data() + base));
      const __m512i prev =
          _mm512_loadu_si512((const void*)(z.data() + base - 1));
      _mm512_storeu_si512((void*)(z.data() + base),
                          glv_sub(prev, glv_mul(dv, cur)));
    }
#endif
    for (j++; j-- > 1;) z[j] = gl_sub(z[j - 1], gl_mul(d, z[j]));
    z[0] = gl_sub(0, gl_mul(d, z[0]));
  }
  // denominators w[i] = Z'(dom[i]) = prod_{j != i} (dom[i] - dom[j]),
  // evaluated as dz = Z' at each point by Horner
  std::vector<u64> dz(n);
  for (size_t j = 0; j < n; j++) {
    dz[j] = gl_mul(z[j + 1], (u64)((j + 1) % P));
  }
  // Per-point O(n) Horner chains: 16 points per pass (two zmm
  // accumulator chains hide the multiply latency); scalar 4-interleave
  // tail below.
  std::vector<u64> w(n);
  size_t i = 0;
#ifdef TIP5_AVX512
  for (; i + 16 <= n; i += 16) {
    const __m512i dv0 = _mm512_loadu_si512((const void*)(dom + i));
    const __m512i dv1 = _mm512_loadu_si512((const void*)(dom + i + 8));
    __m512i a0 = _mm512_set1_epi64((long long)dz[n - 1]);
    __m512i a1 = a0;
    for (size_t j = n - 1; j-- > 0;) {
      const __m512i t = _mm512_set1_epi64((long long)dz[j]);
      a0 = glv_add(glv_mul(a0, dv0), t);
      a1 = glv_add(glv_mul(a1, dv1), t);
    }
    _mm512_storeu_si512((void*)(w.data() + i), a0);
    _mm512_storeu_si512((void*)(w.data() + i + 8), a1);
  }
#endif
  for (; i + 4 <= n; i += 4) {
    const u64 d0 = dom[i], d1 = dom[i + 1], d2 = dom[i + 2], d3 = dom[i + 3];
    u64 a0 = dz[n - 1], a1 = a0, a2 = a0, a3 = a0;
    for (size_t j = n - 1; j-- > 0;) {
      const u64 t = dz[j];
      a0 = gl_add(gl_mul(a0, d0), t);
      a1 = gl_add(gl_mul(a1, d1), t);
      a2 = gl_add(gl_mul(a2, d2), t);
      a3 = gl_add(gl_mul(a3, d3), t);
    }
    w[i] = a0; w[i + 1] = a1; w[i + 2] = a2; w[i + 3] = a3;
  }
  for (; i < n; i++) {
    u64 acc = dz[n - 1];
    for (size_t j = n - 1; j-- > 0;) acc = gl_add(gl_mul(acc, dom[i]), dz[j]);
    w[i] = acc;
  }
  // gl_batch_inverse writes out[i] before reading in[i] — no aliasing
  std::vector<u64> w_inv(n);
  gl_batch_inverse(w.data(), w_inv.data(), n);
  w.swap(w_inv);
  // accumulate vals[i]/w[i] * Z/(x - dom[i]) via synthetic division.
  // AVX path: 8 points per pass; lane-parallel contributions accumulate
  // into a vector row per coefficient (out8), horizontally field-summed
  // once at the end — no per-step reduction.
  for (size_t j = 0; j < n; j++) out[j] = 0;
  i = 0;
#ifdef TIP5_AVX512
  if (n >= 8) {
    std::vector<__m512i> out8(n, _mm512_setzero_si512());
    for (; i + 8 <= n; i += 8) {
      const __m512i cv =
          glv_mul(_mm512_loadu_si512((const void*)(vals + i)),
                  _mm512_loadu_si512((const void*)(w.data() + i)));
      const __m512i dv = _mm512_loadu_si512((const void*)(dom + i));
      __m512i q = _mm512_set1_epi64((long long)z[n]);
      for (size_t j = n; j-- > 0;) {
        out8[j] = glv_add(out8[j], glv_mul(cv, q));
        if (j) q = glv_add(_mm512_set1_epi64((long long)z[j]),
                           glv_mul(dv, q));
      }
    }
    for (size_t j = 0; j < n; j++) out[j] = glv_hsum_field(out8[j]);
  }
#endif
  for (; i + 4 <= n; i += 4) {
    const u64 c0 = gl_mul(vals[i], w[i]);
    const u64 c1 = gl_mul(vals[i + 1], w[i + 1]);
    const u64 c2 = gl_mul(vals[i + 2], w[i + 2]);
    const u64 c3 = gl_mul(vals[i + 3], w[i + 3]);
    const u64 d0 = dom[i], d1 = dom[i + 1], d2 = dom[i + 2], d3 = dom[i + 3];
    u64 q0 = z[n], q1 = q0, q2 = q0, q3 = q0;
    for (size_t j = n; j-- > 0;) {
      u64 acc = gl_add(out[j], gl_mul(c0, q0));
      acc = gl_add(acc, gl_mul(c1, q1));
      acc = gl_add(acc, gl_mul(c2, q2));
      out[j] = gl_add(acc, gl_mul(c3, q3));
      if (j) {
        const u64 t = z[j];
        q0 = gl_add(t, gl_mul(d0, q0));
        q1 = gl_add(t, gl_mul(d1, q1));
        q2 = gl_add(t, gl_mul(d2, q2));
        q3 = gl_add(t, gl_mul(d3, q3));
      }
    }
  }
  for (; i < n; i++) {
    const u64 c = gl_mul(vals[i], w[i]);
    const u64 d = dom[i];
    u64 q = z[n];  // leading coefficient of the quotient (= 1)
    for (size_t j = n; j-- > 0;) {
      out[j] = gl_add(out[j], gl_mul(c, q));
      if (j) q = gl_add(z[j], gl_mul(d, q));
    }
  }
}

u64 gl_mul_scalar(u64 a, u64 b) { return gl_mul(a, b); }
u64 gl_inv_scalar(u64 a) { return gl_inv(a); }
u64 gl_pow_scalar(u64 a, u64 e) { return gl_pow(a, e); }

// Zero-tolerant batch inversion: inverse-or-zero per element
// (traits.rs:39-45 semantics) — zeros pass through the prefix product as 1
// and are zeroed on the way out.
void gl_batch_inverse_or_zero(const u64* in, u64* out, size_t n) {
  if (n == 0) return;
  u64 acc = 1;
  for (size_t i = 0; i < n; i++) {
    out[i] = acc;  // prefix product before element i (zeros skipped)
    if (in[i] != 0) acc = gl_mul(acc, in[i]);
  }
  acc = gl_inv(acc);
  for (size_t i = n; i-- > 0;) {
    if (in[i] == 0) {
      out[i] = 0;
      continue;
    }
    u64 tmp = gl_mul(acc, in[i]);
    out[i] = gl_mul(acc, out[i]);
    acc = tmp;
  }
}

// Montgomery batch inversion (one inverse + 3n muls).
void gl_batch_inverse(const u64* in, u64* out, size_t n) {
  if (n == 0) return;
  u64 acc = 1;
  for (size_t i = 0; i < n; i++) {
    out[i] = acc;  // prefix product before element i
    acc = gl_mul(acc, in[i]);
  }
  acc = gl_inv(acc);
  for (size_t i = n; i-- > 0;) {
    u64 tmp = gl_mul(acc, in[i]);
    out[i] = gl_mul(acc, out[i]);
    acc = tmp;
  }
}

// ---------------------------------------------------------------------------
// Tip5 permutation (scalar, canonical domain)
// ---------------------------------------------------------------------------

static const uint16_t TIP5_LUT_SENTINEL = 0;  // table built at init

static unsigned char LUT[256];
static u64 RC[80];
static u64 MDS_COL[16];
static int tip5_ready = 0;

void tip5_init(const unsigned char* lut, const u64* rc, const u64* mds_col) {
  memcpy(LUT, lut, 256);
  memcpy(RC, rc, 80 * sizeof(u64));
  memcpy(MDS_COL, mds_col, 16 * sizeof(u64));
  tip5_ready = 1;
  (void)TIP5_LUT_SENTINEL;
}

static constexpr u64 R_INV = 0xfffffffe00000001ULL;  // 2^-64 mod p

static inline void tip5_round(u64* s, int r) {
  // S-box: first 4 words via byte LUT on the Montgomery representative
  for (int i = 0; i < 4; i++) {
    u64 m = gl_mul(s[i], EPSILON);  // v * 2^64 mod p
    u64 out = 0;
    for (int byte = 0; byte < 8; byte++) {
      out |= (u64)LUT[(m >> (8 * byte)) & 0xff] << (8 * byte);
    }
    s[i] = gl_mul(out, R_INV);  // back to canonical: out * 2^-64 mod p
  }
  for (int i = 4; i < 16; i++) {
    u64 sq = gl_mul(s[i], s[i]);
    u64 qu = gl_mul(sq, sq);
    s[i] = gl_mul(gl_mul(qu, sq), s[i]);
  }
  // MDS: circulant matvec on 32-bit word halves (the same split the
  // reference's scalar path uses, tip5/mod.rs:753-764, with a SIMD-friendly
  // rotate-and-axpy loop instead of its recursive scalar convolution).
  // Each half-product col(<2^16) * half(<2^32) < 2^48; 16-term sums stay
  // < 2^52, so both accumulators fit u64 and the inner loop is a
  // unit-stride vectorizable multiply-add.
  u64 s2lo[32], s2hi[32];
  for (int j = 0; j < 16; j++) {
    const u64 lo32 = s[j] & 0xffffffffULL, hi32 = s[j] >> 32;
    s2lo[j] = lo32;
    s2lo[j + 16] = lo32;
    s2hi[j] = hi32;
    s2hi[j + 16] = hi32;
  }
  u64 alo[16] = {0}, ahi[16] = {0};
  for (int k = 0; k < 16; k++) {
    const u64 c = MDS_COL[k];
    const u64* pl = s2lo + 16 - k;
    const u64* ph = s2hi + 16 - k;
    for (int i = 0; i < 16; i++) {
      alo[i] += c * pl[i];
      ahi[i] += c * ph[i];
    }
  }
  for (int i = 0; i < 16; i++) {
    const u128 acc = (u128)alo[i] + ((u128)ahi[i] << 32);
    s[i] = gl_add(reduce128(acc), RC[16 * r + i]);
  }
}

// --- 8-lane SoA permutation: the host analogue of the reference's
// AVX-512 backend. All field ops are expressed as branchless loops over
// 8 u64 lanes (one AVX-512 register) with 32-bit-split multiplies whose
// partial products stay < 2^64, so the compiler vectorizes them with
// vpmullq/vpmuludq under -march=native. Only the byte-LUT S-box stays
// scalar per lane (a gather; 256 byte ops/round vs ~3k vectorized
// mul-lane-ops — not the bottleneck).

#define L8 8

static inline void gl_mul8(const u64* a, const u64* b, u64* out) {
  for (int l = 0; l < L8; l++) {
    const u64 ll = (a[l] & 0xffffffffULL) * (b[l] & 0xffffffffULL);
    const u64 lh = (a[l] & 0xffffffffULL) * (b[l] >> 32);
    const u64 hl = (a[l] >> 32) * (b[l] & 0xffffffffULL);
    const u64 hh = (a[l] >> 32) * (b[l] >> 32);
    const u64 cross = lh + hl;
    const u64 cross_c = (u64)(cross < lh) << 32;  // carry weight 2^96 -> hi bit 32
    const u64 lo = ll + (cross << 32);
    const u64 c0 = (u64)(lo < ll);
    const u64 hi = hh + (cross >> 32) + cross_c + c0;
    // Goldilocks reduction of (lo, hi), branchless
    const u64 hi_hi = hi >> 32;
    u64 t0 = lo - hi_hi;
    t0 -= EPSILON & (u64)(0 - (u64)(lo < hi_hi));
    const u64 t1 = (hi & 0xffffffffULL) * EPSILON;
    u64 res = t0 + t1;
    res += EPSILON & (u64)(0 - (u64)(res < t0));
    res -= P & (u64)(0 - (u64)(res >= P));
    out[l] = res;
  }
}

static inline void gl_add8(const u64* a, const u64* b, u64* out) {
  for (int l = 0; l < L8; l++) {
    u64 s = a[l] + b[l];
    s += EPSILON & (u64)(0 - (u64)(s < a[l]));
    s -= P & (u64)(0 - (u64)(s >= P));
    out[l] = s;
  }
}

// --- AVX-512 intrinsics variant of the 8-lane round ------------------------
//
// gcc 12 never converts the scalar 32-bit-split multiplies above into
// vpmuludq — every product becomes the microcoded vpmullq (measured 2.5x
// slower per dependent op on this part). The reference solves the same
// problem with explicit AVX-512 (tip5/avx512.rs); we do the equivalent
// here: one __m512i per state word (8 lanes), vpmuludq partial products,
// mask-register carry/wrap corrections. Bit-identical to the scalar
// kernel (same operation order and corrections lane-wise).

#ifdef TIP5_AVX512
static void tip5_round8_avx512(u64 s[16][L8], int r) {
  const __m512i mask32 = _mm512_set1_epi64((long long)0xffffffffULL);
  const __m512i veps = _mm512_set1_epi64((long long)EPSILON);
  const __m512i vrinv = _mm512_set1_epi64((long long)R_INV);
  __m512i v[16];
  for (int i = 0; i < 16; i++)
    v[i] = _mm512_loadu_si512((const void*)s[i]);
  // S-box words 0..3: Montgomery bytes -> LUT -> back. One word-vector's
  // Montgomery rep is exactly 64 bytes = one zmm, and the 256-byte LUT is
  // 4 zmm: two vpermi2b 128-entry lookups blended by each index byte's
  // top bit (AVX512-VBMI), replacing 64 scalar byte extractions per word.
#ifdef __AVX512VBMI__
  const __m512i lut0 = _mm512_loadu_si512((const void*)(LUT + 0));
  const __m512i lut1 = _mm512_loadu_si512((const void*)(LUT + 64));
  const __m512i lut2 = _mm512_loadu_si512((const void*)(LUT + 128));
  const __m512i lut3 = _mm512_loadu_si512((const void*)(LUT + 192));
  for (int i = 0; i < 4; i++) {
    const __m512i m = glv_mul(v[i], veps);
    const __m512i sello = _mm512_permutex2var_epi8(lut0, m, lut1);
    const __m512i selhi = _mm512_permutex2var_epi8(lut2, m, lut3);
    const __mmask64 top = _mm512_movepi8_mask(m);  // bit 7 of each byte
    v[i] = glv_mul(_mm512_mask_blend_epi8(top, sello, selhi), vrinv);
  }
#else
  for (int i = 0; i < 4; i++) {
    alignas(64) u64 m[L8], t[L8];
    _mm512_storeu_si512((void*)m, glv_mul(v[i], veps));
    for (int l = 0; l < L8; l++) {
      u64 out = 0;
      for (int byte = 0; byte < 8; byte++)
        out |= (u64)LUT[(m[l] >> (8 * byte)) & 0xff] << (8 * byte);
      t[l] = out;
    }
    v[i] = glv_mul(_mm512_loadu_si512((const void*)t), vrinv);
  }
#endif
  // words 4..15: x^7
  for (int i = 4; i < 16; i++) {
    const __m512i sq = glv_mul(v[i], v[i]);
    const __m512i qu = glv_mul(sq, sq);
    v[i] = glv_mul(glv_mul(qu, sq), v[i]);
  }
  // MDS circulant on 32-bit halves: vpmuludq axpy, accumulators < 2^52
  __m512i slo[16], shi[16];
  for (int j = 0; j < 16; j++) {
    slo[j] = _mm512_and_si512(v[j], mask32);
    shi[j] = _mm512_srli_epi64(v[j], 32);
  }
  for (int i = 0; i < 16; i++) {
    __m512i alo = _mm512_setzero_si512(), ahi = _mm512_setzero_si512();
    for (int k = 0; k < 16; k++) {
      // row i tap k reads input word (i - k) mod 16 (circulant)
      const int j = (i - k) & 15;
      const __m512i c = _mm512_set1_epi64((long long)MDS_COL[k]);
      alo = _mm512_add_epi64(alo, _mm512_mul_epu32(c, slo[j]));
      ahi = _mm512_add_epi64(ahi, _mm512_mul_epu32(c, shi[j]));
    }
    // value = alo + 2^32*ahi -> (lo, hi) pair, then Goldilocks-reduce
    const __m512i lo = _mm512_add_epi64(alo, _mm512_slli_epi64(ahi, 32));
    const __mmask8 c0 = _mm512_cmplt_epu64_mask(lo, alo);
    __m512i hi = _mm512_srli_epi64(ahi, 32);
    hi = _mm512_mask_add_epi64(hi, c0, hi, _mm512_set1_epi64(1));
    const __m512i rc =
        _mm512_set1_epi64((long long)RC[16 * r + i]);
    v[i] = glv_add(glv_reduce(lo, hi), rc);
  }
  for (int i = 0; i < 16; i++)
    _mm512_storeu_si512((void*)s[i], v[i]);
}
#endif  // __AVX512F__ && __AVX512DQ__

static void tip5_round8(u64 s[16][L8], int r) {
  static const u64 EPS8[L8] = {EPSILON, EPSILON, EPSILON, EPSILON,
                               EPSILON, EPSILON, EPSILON, EPSILON};
  static const u64 RINV8[L8] = {R_INV, R_INV, R_INV, R_INV,
                                R_INV, R_INV, R_INV, R_INV};
  u64 tmp[L8], tmp2[L8];
  // S-box words 0..3: byte LUT on the Montgomery representative
  for (int i = 0; i < 4; i++) {
    gl_mul8(s[i], EPS8, tmp);
    for (int l = 0; l < L8; l++) {
      const u64 m = tmp[l];
      u64 out = 0;
      for (int byte = 0; byte < 8; byte++) {
        out |= (u64)LUT[(m >> (8 * byte)) & 0xff] << (8 * byte);
      }
      tmp2[l] = out;
    }
    gl_mul8(tmp2, RINV8, s[i]);
  }
  // words 4..15: x^7
  for (int i = 4; i < 16; i++) {
    u64 sq[L8], qu[L8];
    gl_mul8(s[i], s[i], sq);
    gl_mul8(sq, sq, qu);
    gl_mul8(qu, sq, tmp);
    gl_mul8(tmp, s[i], s[i]);
  }
  // MDS on 32-bit halves: rotate-and-axpy, accumulators < 2^52
  u64 s2lo[32][L8], s2hi[32][L8];
  for (int j = 0; j < 16; j++) {
    for (int l = 0; l < L8; l++) {
      const u64 lo32 = s[j][l] & 0xffffffffULL, hi32 = s[j][l] >> 32;
      s2lo[j][l] = lo32;
      s2lo[j + 16][l] = lo32;
      s2hi[j][l] = hi32;
      s2hi[j + 16][l] = hi32;
    }
  }
  u64 alo[16][L8] = {{0}}, ahi[16][L8] = {{0}};
  for (int k = 0; k < 16; k++) {
    const u64 c = MDS_COL[k];
    for (int i = 0; i < 16; i++) {
      const u64* pl = s2lo[16 - k + i];
      const u64* ph = s2hi[16 - k + i];
      for (int l = 0; l < L8; l++) {
        // operands < 2^16 / < 2^32; masked multiplies compile to vpmuludq
        alo[i][l] += (c & 0xffffffffULL) * (pl[l] & 0xffffffffULL);
        ahi[i][l] += (c & 0xffffffffULL) * (ph[l] & 0xffffffffULL);
      }
    }
  }
  for (int i = 0; i < 16; i++) {
    u64 red[L8], rc[L8];
    for (int l = 0; l < L8; l++) {
      // (alo + (ahi << 32)) mod p without u128: alo < 2^52, ahi < 2^52
      const u64 lo = alo[i][l] + (ahi[i][l] << 32);
      const u64 carry = (u64)(lo < alo[i][l]);
      const u64 hi = (ahi[i][l] >> 32) + carry;   // < 2^21
      // value = lo + 2^64*hi; reduce: 2^64 == EPSILON (mod p)
      const u64 hi_hi = hi >> 32;  // == 0 (hi < 2^21)
      u64 t0 = lo - hi_hi;
      t0 -= EPSILON & (u64)(0 - (u64)(lo < hi_hi));
      const u64 t1 = (hi & 0xffffffffULL) * EPSILON;
      u64 res = t0 + t1;
      res += EPSILON & (u64)(0 - (u64)(res < t0));
      res -= P & (u64)(0 - (u64)(res >= P));
      red[l] = res;
      rc[l] = RC[16 * r + i];
    }
    gl_add8(red, rc, s[i]);
  }
}

static void tip5_permute_block8(u64* states) {
  // AoS (8, 16) -> SoA [16][8], 5 rounds, back
  alignas(64) u64 s[16][L8];
  for (int i = 0; i < 16; i++)
    for (int l = 0; l < L8; l++) s[i][l] = states[16 * l + i];
#ifdef TIP5_AVX512
  for (int r = 0; r < 5; r++) tip5_round8_avx512(s, r);
#else
  for (int r = 0; r < 5; r++) tip5_round8(s, r);
#endif
  for (int i = 0; i < 16; i++)
    for (int l = 0; l < L8; l++) states[16 * l + i] = s[i][l];
}

void tip5_permute_batch(u64* states, size_t batch) {
  // Batch parallelism matches the reference's rayon par_iter hashing
  // (merkle_tree.rs:299-364); each state is independent. Blocks of 8
  // run the SoA lane kernel; the tail stays scalar.
  const size_t blocks = batch / L8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (blocks >= 64)
#endif
  for (size_t b = 0; b < blocks; b++) {
    tip5_permute_block8(states + 16 * L8 * b);
  }
  for (size_t b = blocks * L8; b < batch; b++) {
    u64* s = states + 16 * b;
    for (int r = 0; r < 5; r++) tip5_round(s, r);
  }
}

// One Merkle layer: (2b, 5) digest rows -> (b, 5) via hash_pair
// (fixed-length domain: capacity words = 1; tip5/mod.rs hash_pair).
// States live on the stack — no (b, 16) staging buffer; blocks of 8
// pairs run the SoA lane kernel.
void tip5_hash_pairs(const u64* nodes, u64* out, size_t b) {
  const size_t blocks = b / L8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (blocks >= 32)
#endif
  for (size_t blk = 0; blk < blocks; blk++) {
    u64 s[L8 * 16];
    for (int l = 0; l < L8; l++) {
      const size_t i = blk * L8 + l;
      memcpy(s + 16 * l, nodes + 10 * i, 10 * sizeof(u64));
      for (int j = 10; j < 16; j++) s[16 * l + j] = 1;
    }
    tip5_permute_block8(s);
    for (int l = 0; l < L8; l++)
      memcpy(out + 5 * (blk * L8 + l), s + 16 * l, 5 * sizeof(u64));
  }
  for (size_t i = blocks * L8; i < b; i++) {
    u64 s[16];
    memcpy(s, nodes + 10 * i, 10 * sizeof(u64));
    for (int j = 10; j < 16; j++) s[j] = 1;
    for (int r = 0; r < 5; r++) tip5_round(s, r);
    memcpy(out + 5 * i, s, 5 * sizeof(u64));
  }
}

// Whole variable-length sponge hash in one native call: overwrite-mode
// absorb of 10-word chunks with the 1||0* final-chunk padding
// (tip5/mod.rs hash_varlen semantics; sponge state starts all-zero in
// the variable-length domain). vals: n words; out: 5-word digest.
void tip5_hash_varlen(const u64* vals, size_t n, u64* out) {
  u64 s[16] = {0};
  const size_t full = n / 10;
  for (size_t c = 0; c < full; c++) {
    memcpy(s, vals + 10 * c, 10 * sizeof(u64));
    for (int r = 0; r < 5; r++) tip5_round(s, r);
  }
  u64 last[10] = {0};
  const size_t rem = n - full * 10;
  if (rem) memcpy(last, vals + full * 10, rem * sizeof(u64));
  last[rem] = 1;
  memcpy(s, last, 10 * sizeof(u64));
  for (int r = 0; r < 5; r++) tip5_round(s, r);
  memcpy(out, s, 5 * sizeof(u64));
}

// Frugal Merkle root fully in native code: repeated layer halving between
// two ping-pong scratch buffers — in-place halving would race under the
// OpenMP layer parallelism (reference: sequential/par_frugal_root,
// merkle_tree.rs:299-364). leafs: (n, 5), n a power of two; root: 5 words.
void tip5_merkle_root(const u64* leafs, u64* root, size_t n) {
  if (n == 1) {
    memcpy(root, leafs, 5 * sizeof(u64));
    return;
  }
  size_t m = n / 2;
  u64* a = (u64*)malloc(m * 5 * sizeof(u64));
  u64* b = (u64*)malloc(((m / 2) ? (m / 2) : 1) * 5 * sizeof(u64));
  tip5_hash_pairs(leafs, a, m);
  while (m > 1) {
    tip5_hash_pairs(a, b, m / 2);
    u64* t = a;
    a = b;
    b = t;
    m /= 2;
  }
  memcpy(root, a, 5 * sizeof(u64));
  free(a);
  free(b);
}

// ---------------------------------------------------------------------------
// NTT (iterative radix-2, natural order in/out via bit-reversal)
// ---------------------------------------------------------------------------

static inline uint32_t bitrev32(uint32_t k) {
  k = ((k & 0x55555555u) << 1) | ((k & 0xaaaaaaaau) >> 1);
  k = ((k & 0x33333333u) << 2) | ((k & 0xccccccccu) >> 2);
  k = ((k & 0x0f0f0f0fu) << 4) | ((k & 0xf0f0f0f0u) >> 4);
  k = ((k & 0x00ff00ffu) << 8) | ((k & 0xff00ff00u) >> 8);
  return (k << 16) | (k >> 16);
}

// In-place NTT; root must be a primitive n-th root of unity.
void gl_ntt(u64* x, size_t n, u64 root) {
  if (n <= 1) return;
  uint32_t log_n = 0;
  while ((1u << log_n) < n) log_n++;
  for (uint32_t k = 0; k < n; k++) {
    uint32_t rev = bitrev32(k) >> (32 - log_n);
    if (k < rev) { u64 t = x[k]; x[k] = x[rev]; x[rev] = t; }
  }
  for (size_t m = 1; m < n; m *= 2) {
    u64 w_m = gl_pow(root, n / (2 * m));
    for (size_t k = 0; k < n; k += 2 * m) {
      u64 w = 1;
      for (size_t j = 0; j < m; j++) {
        u64 u = x[k + j];
        u64 v = gl_mul(x[k + j + m], w);
        x[k + j] = gl_add(u, v);
        x[k + j + m] = gl_sub(u, v);
        w = gl_mul(w, w_m);
      }
    }
  }
}

void gl_intt(u64* x, size_t n, u64 root_inv) {
  gl_ntt(x, n, root_inv);
  u64 n_inv = gl_inv((u64)n);
  for (size_t i = 0; i < n; i++) x[i] = gl_mul(x[i], n_inv);
}

// Row-batched in-place NTT: `rows` contiguous transforms of length n,
// with the per-stage twiddle table precomputed by the caller (stage s of
// log2(n) holds 2^s entries, concatenated; total n-1). n_inv != 0 applies
// the inverse 1/n scaling (caller passes inverse-root twiddles then).
// Replaces the python host-NTT's per-stage numpy passes with one call.
// One stage block of m butterflies, branchless 32-bit-split math the
// compiler can vectorize (same formulation as the 8-lane Tip5 kernel):
// (a[j], b[j]) <- (a[j] + tw[j]*b[j], a[j] - tw[j]*b[j]).
static inline void gl_butterflies_vec(u64* a, u64* b, const u64* tw,
                                      size_t m) {
  size_t j = 0;
#ifdef TIP5_AVX512
  for (; j + 8 <= m; j += 8) {
    const __m512i v = glv_mul(_mm512_loadu_si512((const void*)(b + j)),
                              _mm512_loadu_si512((const void*)(tw + j)));
    const __m512i u = _mm512_loadu_si512((const void*)(a + j));
    _mm512_storeu_si512((void*)(a + j), glv_add(u, v));
    _mm512_storeu_si512((void*)(b + j), glv_sub(u, v));
  }
#endif
  for (; j < m; j++) {
    const u64 x = b[j], w = tw[j];
    const u64 a0 = x & 0xffffffffULL, a1 = x >> 32;
    const u64 b0 = w & 0xffffffffULL, b1 = w >> 32;
    const u64 ll = a0 * b0, lh = a0 * b1, hl = a1 * b0, hh = a1 * b1;
    const u64 cross = lh + hl;
    const u64 cross_c = (u64)(cross < lh) << 32;
    const u64 lo = ll + (cross << 32);
    const u64 c0 = (u64)(lo < ll);
    const u64 hi = hh + (cross >> 32) + cross_c + c0;
    const u64 hi_hi = hi >> 32, hi_lo = hi & 0xffffffffULL;
    u64 t0 = lo - hi_hi;
    t0 -= EPSILON & (u64)(0 - (u64)(lo < hi_hi));
    const u64 t1 = hi_lo * EPSILON;
    u64 v = t0 + t1;
    v += EPSILON & (u64)(0 - (u64)(v < t0));
    v -= P & (u64)(0 - (u64)(v >= P));
    const u64 u = a[j];
    u64 s = u + v;
    s += EPSILON & (u64)(0 - (u64)(s < u));
    s -= P & (u64)(0 - (u64)(s >= P));
    u64 d = u - v;
    d -= EPSILON & (u64)(0 - (u64)(u < v));
    a[j] = s;
    b[j] = d;
  }
}

static void gl_ntt_one_row(u64* row, size_t n, uint32_t log_n,
                           const u64* stage_tw, u64 n_inv, int par) {
  for (uint32_t k = 0; k < n; k++) {
    uint32_t rev = bitrev32(k) >> (32 - log_n);
    if (k < rev) { u64 t = row[k]; row[k] = row[rev]; row[rev] = t; }
  }
  const u64* tw = stage_tw;
  for (size_t m = 1; m < n; m *= 2) {
    const size_t blocks = n / (2 * m);
    if (par && blocks >= 8) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (size_t blk = 0; blk < blocks; blk++) {
        const size_t k = blk * 2 * m;
        gl_butterflies_vec(row + k, row + k + m, tw, m);
      }
    } else {
      for (size_t k = 0; k < n; k += 2 * m) {
        gl_butterflies_vec(row + k, row + k + m, tw, m);
      }
    }
    tw += m;
  }
  if (n_inv) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par && n >= (size_t{1} << 16))
#endif
    for (size_t i = 0; i < n; i++) row[i] = gl_mul(row[i], n_inv);
  }
}

void gl_ntt_rows(u64* x, size_t rows, size_t n, const u64* stage_tw,
                 u64 n_inv) {
  if (n <= 1) return;
  uint32_t log_n = 0;
  while ((size_t{1} << log_n) < n) log_n++;
  if (rows >= 2) {
    // batch parallelism across rows; each row transform stays serial
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (rows * n >= (size_t{1} << 14))
#endif
    for (size_t r = 0; r < rows; r++) {
      gl_ntt_one_row(x + r * n, n, log_n, stage_tw, n_inv, 0);
    }
    return;
  }
  // single large row: parallelize within each butterfly stage
  gl_ntt_one_row(x, n, log_n, stage_tw, n_inv, n >= (size_t{1} << 16));
}

// ---------------------------------------------------------------------------
// Polynomial long division (remainder + quotient)
// ---------------------------------------------------------------------------

// num (len dn+1), den (len dd+1), quot (len dn-dd+1), rem (len dd).
// Caller guarantees dn >= dd >= 0 and den[dd] != 0.
// Whole chunked reduction by an NTT-friendly structured modulus
// (polynomial.rs:1087-1144; the Python loop in
// reduce_by_ntt_friendly_modulus moved into one call): repeatedly fold
// the top chunk through intt(ntt(chunk) * shift_ntt). coeffs: n words;
// shift_ntt: domain_len natural-order NTT values; stage twiddles and
// n_inv as in gl_ntt_rows. out: chunk+tail = domain_len words (the
// surviving window, little-endian coefficient order).
void gl_reduce_by_ntt_modulus(const u64* coeffs, size_t n,
                              const u64* shift_ntt, size_t domain_len,
                              size_t tail_len, const u64* tw_f,
                              const u64* tw_i, u64 n_inv, u64* out) {
  const size_t chunk = domain_len - tail_len;
  uint32_t log_n = 0;
  while ((size_t{1} << log_n) < domain_len) log_n++;
  u64* window = out;  // chunk + tail
  const size_t win_len = chunk + tail_len;
  // initial window = top partial chunk
  const size_t num_chunks =
      (n - (tail_len + chunk) + chunk - 1) / chunk;  // caller ensures n >= win_len
  const size_t range_start = num_chunks * chunk;
  memset(window, 0, win_len * sizeof(u64));
  if (range_start < n) {
    memcpy(window, coeffs + range_start, (n - range_start) * sizeof(u64));
  }
  u64* product = new u64[domain_len];
  u64* tail_save = new u64[tail_len ? tail_len : 1];
  for (size_t ci = num_chunks; ci-- > 0;) {
    memcpy(product, window + tail_len, chunk * sizeof(u64));
    memset(product + chunk, 0, tail_len * sizeof(u64));
    gl_ntt_one_row(product, domain_len, log_n, tw_f, 0, 0);
    for (size_t i = 0; i < domain_len; i++) {
      product[i] = gl_mul(product[i], shift_ntt[i]);
    }
    gl_ntt_one_row(product, domain_len, log_n, tw_i, n_inv, 0);
    memcpy(tail_save, window, tail_len * sizeof(u64));
    const size_t stop = (chunk < n - ci * chunk) ? chunk : n - ci * chunk;
    memcpy(window, coeffs + ci * chunk, stop * sizeof(u64));
    if (stop < chunk) memset(window + stop, 0, (chunk - stop) * sizeof(u64));
    memcpy(window + chunk, tail_save, tail_len * sizeof(u64));
    for (size_t i = 0; i < win_len; i++) {
      window[i] = gl_sub(window[i], product[i]);
    }
  }
  delete[] product;
  delete[] tail_save;
}

// Multipoint evaluation by lane-blocked Horner: 8 points per vector
// register, OpenMP across blocks. The per-point mul->add dependency chain
// hides across the 8 lanes; k*m total mul-adds. out[i] = P(pts[i]).
void gl_horner_points(const u64* coeffs, size_t k, const u64* pts,
                      size_t m, u64* out) {
  if (k == 0) {
    memset(out, 0, m * sizeof(u64));
    return;
  }
  // 4 interleaved 8-lane chains per thread iteration (32 points): the
  // mul->add recurrence is latency-bound per chain (~20+ cycles), so
  // independent chains are what buy throughput, not wider vectors.
  // 4 chains measured best for the AVX path too (8 chains: 54.6 vs
  // 51.6 ms at 2^18x2^10 — the vpmuludq ports saturate before latency)
  const size_t NCH = 4;
  const size_t W = NCH * L8;
  const size_t big = m / W;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (big * k >= (size_t{1} << 16))
#endif
  for (size_t blk = 0; blk < big; blk++) {
#ifdef TIP5_AVX512
    __m512i xv[NCH], av[NCH];
    for (size_t v = 0; v < NCH; v++) {
      xv[v] = _mm512_loadu_si512((const void*)(pts + blk * W + v * L8));
      av[v] = _mm512_set1_epi64((long long)coeffs[k - 1]);
    }
    for (size_t j = k - 1; j-- > 0;) {
      const __m512i c = _mm512_set1_epi64((long long)coeffs[j]);
      for (size_t v = 0; v < NCH; v++)
        av[v] = glv_add(glv_mul(av[v], xv[v]), c);
    }
    for (size_t v = 0; v < NCH; v++)
      _mm512_storeu_si512((void*)(out + blk * W + v * L8), av[v]);
#else
    u64 x[4][L8], acc[4][L8], c8[L8], t[4][L8];
    for (int v = 0; v < 4; v++) {
      for (int l = 0; l < L8; l++) {
        x[v][l] = pts[blk * W + v * L8 + l];
        acc[v][l] = coeffs[k - 1];
      }
    }
    for (size_t j = k - 1; j-- > 0;) {
      const u64 c = coeffs[j];
      for (int l = 0; l < L8; l++) c8[l] = c;
      for (int v = 0; v < 4; v++) gl_mul8(acc[v], x[v], t[v]);
      for (int v = 0; v < 4; v++) gl_add8(t[v], c8, acc[v]);
    }
    for (int v = 0; v < 4; v++)
      memcpy(out + blk * W + v * L8, acc[v], L8 * sizeof(u64));
#endif
  }
  const size_t blocks = m / L8;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if ((blocks - big * NCH) * k >= (size_t{1} << 16))
#endif
  for (size_t blk = big * NCH; blk < blocks; blk++) {
    u64 x[L8], acc[L8], c8[L8], t[L8];
    for (int l = 0; l < L8; l++) {
      x[l] = pts[blk * L8 + l];
      acc[l] = coeffs[k - 1];
    }
    for (size_t j = k - 1; j-- > 0;) {
      const u64 c = coeffs[j];
      for (int l = 0; l < L8; l++) c8[l] = c;
      gl_mul8(acc, x, t);
      gl_add8(t, c8, acc);
    }
    memcpy(out + blk * L8, acc, L8 * sizeof(u64));
  }
  for (size_t i = blocks * L8; i < m; i++) {
    u64 acc = coeffs[k - 1];
    for (size_t j = k - 1; j-- > 0;) {
      acc = gl_add(gl_mul(acc, pts[i]), coeffs[j]);
    }
    out[i] = acc;
  }
}

void gl_poly_divmod(const u64* num, size_t dn, const u64* den, size_t dd,
                    u64* quot, u64* rem) {
  u64* work = new u64[dn + 1];
  memcpy(work, num, (dn + 1) * sizeof(u64));
  u64 lc_inv = gl_inv(den[dd]);
  for (size_t i = dn - dd + 1; i-- > 0;) {
    u64 q = gl_mul(work[i + dd], lc_inv);
    quot[i] = q;
    if (q != 0) {
      for (size_t j = 0; j <= dd; j++) {
        work[i + j] = gl_sub(work[i + j], gl_mul(q, den[j]));
      }
    }
  }
  memcpy(rem, work, dd * sizeof(u64));
  delete[] work;
}

}  // extern "C"
