// Lane code of the strip-wavefront Smith-Waterman kernels (sw_kernels.cu).
//
// One warp aligns one pair.  The A side (rows) is cut into passes of
// 32*K rows; in a pass, lane t owns the K rows starting at
// pass*32*K + t*K and sweeps the B side (columns) one column per step,
// one step behind lane t-1, from which it receives the bottom two H rows
// and the bottom E row of the strip above (a warp shuffle on the card).
// Lane 0 receives them from the previous pass's lane 31 through a
// per-pair boundary buffer in device memory (or the DP's "minus infinity"
// in the first pass).
//
// The recurrences are those of ops/sw_np.py (the reference kernel,
// src/sw.cpp:79-212) evaluated cell by cell in the same float order, so
// the values, tie decisions and traceback bits equal the wavefront's:
//   E(i,j) = pref_open(H(i-2,j-1) + open, E(i-1,j) + ext)
//   F(i,j) = pref_open(H(i-1,j-2) + open, F(i,j-1) + ext)
//   H(i,j) = select(H(i-1,j-1), E, F, 0) + S(i,j)
//
// This header holds everything but the warp glue, so the same code runs
// on the card and, lane by lane, on the host (sw_lanes_cpu.cpp, which the
// tests use to check it against the numpy reference).

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SWL_HD __host__ __device__ __forceinline__
#else
#define SWL_HD inline
#endif

namespace swl {

constexpr int WARP = 32;
// Mu filter: 36 letters plus the padding letter 36
constexpr int MU_ALPHA = 37;
constexpr int MU_PAD = 36;
// integer DP "minus infinity" and padding-letter score: far below any
// reachable score (|score| < 2^16), far above int32 overflow
constexpr int MU_NEG = -(1 << 28);
constexpr int MU_PAD_SCORE = -(1 << 27);
// float DP "minus infinity" (reference MINUS_INFINITY, src/xdpmem.h:6)
constexpr float NEG = -9e9f;
constexpr int MAX_FEATURES = 8;

// rows per lane for an A side of `la` rows: one pass of 32*K rows covers
// the small buckets without idle lanes, K = 16 beyond
SWL_HD int lanes_k(int la) { return la <= 128 ? 4 : (la <= 256 ? 8 : 16); }

SWL_HD int imax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------- Mu filter
template <int K>
struct MuLane {
  int hc1[K];   // H(r, j-1)
  int hc2[K];   // H(r, j-2)
  int f[K];     // F(r, j-1)
  int arow[K];  // A letter of row r, times MU_ALPHA
  int up1;      // H(i0-1, j-1): bottom row of the strip above
  int up2;      // H(i0-1, j-2)
  int upb;      // H(i0-2, j-1)
  int best;
};

template <int K>
SWL_HD void mu_begin_pass(MuLane<K>& L, const uint8_t* a, int la, int i0) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = i0 + r;
    L.arow[r] = (i < la ? a[i] : MU_PAD) * MU_ALPHA;
    L.hc1[r] = L.hc2[r] = L.f[r] = MU_NEG;
  }
  L.up1 = L.up2 = L.upb = MU_NEG;
}

// One column j of the lane's strip.  in_*: H(i0-1, j), H(i0-2, j),
// E(i0-1, j).  out: H(i0+K-1, j), H(i0+K-2, j), E(i0+K-1, j).
template <int K>
SWL_HD void mu_step(MuLane<K>& L, const int* tbl, int bj, int in_h,
                    int in_h2, int in_e, int open, int ext, int* out) {
  const int* col = tbl + bj;
  int d1 = L.up1;   // H(r-1, j-1)
  int d12 = L.up2;  // H(r-1, j-2)
  int d2 = L.upb;   // H(r-2, j-1)
  int ecar = in_e;  // E(r-1, j)
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = col[L.arow[r]];
    const int e = imax(d2 + open, ecar + ext);
    const int f = imax(d12 + open, L.f[r] + ext);
    const int h = imax(imax(d1, e), imax(f, 0)) + s;
    d2 = d1;
    d1 = L.hc1[r];
    d12 = L.hc2[r];
    L.hc2[r] = L.hc1[r];
    L.hc1[r] = h;
    L.f[r] = f;
    ecar = e;
    L.best = imax(L.best, h);
  }
  L.up2 = L.up1;
  L.up1 = in_h;
  L.upb = in_h2;
  out[0] = L.hc1[K - 1];
  out[1] = L.hc1[K - 2];
  out[2] = ecar;
}

// ------------------------------------------------- profile SW + traceback
// Substitution tables: feature f's (sz_f+1)^2 block starts at base[f] with
// row stride stride[f] = sz_f + 1; code sz_f is padding.  Codes are packed
// 4 per word, features 0-3 in w0 and 4-7 in w1.
SWL_HD int code_of(uint32_t w0, uint32_t w1, int f) {
  return (int)(((f < 4 ? w0 : w1) >> (8 * (f & 3))) & 255u);
}

// S(i,j) = sum over features in feature order (the reference's
// SetSMx_NoRev, src/dssaligner.cpp:529-611; ops/smx_jax.smx_batch_gather)
SWL_HD float subst(const float* tbl, const int* base, const int* stride,
                   int nf, uint32_t a0, uint32_t a1, uint32_t b0,
                   uint32_t b1) {
  float s = tbl[base[0] + code_of(a0, a1, 0) * stride[0] + code_of(b0, b1, 0)];
#pragma unroll
  for (int f = 1; f < MAX_FEATURES; ++f) {
    if (f < nf) {
      s = s + tbl[base[f] + code_of(a0, a1, f) * stride[f]
                  + code_of(b0, b1, f)];
    }
  }
  return s;
}

template <int K>
struct AlnLane {
  float hc1[K];
  float hc2[K];
  float f[K];
  uint32_t a0[K];
  uint32_t a1[K];
  float up1, up2, upb;
  float best;
  int bi, bj;
};

// (h, i, j) beats the lane's best: larger value, then first row-major
// cell; only positive values count (sw_jax.sw_traceback_batch rule)
SWL_HD bool better(float h, int i, int j, float best, int bi, int bj) {
  return h > best
         || (h == best && best > 0.0f && (i < bi || (i == bi && j < bj)));
}

template <int K>
SWL_HD void aln_begin_pass(AlnLane<K>& L, const uint8_t* pa, int la, int i0,
                           uint32_t pad0, uint32_t pad1) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = i0 + r;
    if (i < la) {
      const uint8_t* c = pa + (size_t)i * MAX_FEATURES;
      L.a0[r] = c[0] | (c[1] << 8) | (c[2] << 16) | ((uint32_t)c[3] << 24);
      L.a1[r] = c[4] | (c[5] << 8) | (c[6] << 16) | ((uint32_t)c[7] << 24);
    } else {
      L.a0[r] = pad0;
      L.a1[r] = pad1;
    }
    L.hc1[r] = L.hc2[r] = L.f[r] = NEG;
  }
  L.up1 = L.up2 = L.upb = NEG;
}

// One column j; tbw receives the K traceback bytes of the strip's cells,
// packed little-endian 4 per word (bits 0-1 match source, bit 2 E
// opened, bit 3 F opened).
template <int K>
SWL_HD void aln_step(AlnLane<K>& L, const float* tbl, const int* base,
                     const int* stride, int nf, uint32_t b0, uint32_t b1,
                     float in_h, float in_h2, float in_e, float open,
                     float ext, int i0, int j, float* out, uint32_t* tbw) {
  float d1 = L.up1;
  float d12 = L.up2;
  float d2 = L.upb;
  float ecar = in_e;
#pragma unroll
  for (int w = 0; w < K / 4; ++w) tbw[w] = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const float s = subst(tbl, base, stride, nf, L.a0[r], L.a1[r], b0, b1);
    const float e_open = d2 + open;
    const float e_ext = ecar + ext;
    const bool ep = e_open >= e_ext;
    const float e = ep ? e_open : e_ext;
    const float f_open = d12 + open;
    const float f_ext = L.f[r] + ext;
    const bool fp = f_open >= f_ext;
    const float f = fp ? f_open : f_ext;
    float m = d1;
    int src = 0;
    if (e > m) { m = e; src = 1; }
    if (f > m) { m = f; src = 2; }
    if (0.0f >= m) { m = 0.0f; src = 3; }
    const float h = m + s;
    const uint32_t bits = (uint32_t)(src | (ep ? 4 : 0) | (fp ? 8 : 0));
    tbw[r / 4] |= bits << (8 * (r % 4));
    if (better(h, i0 + r, j, L.best, L.bi, L.bj)) {
      L.best = h;
      L.bi = i0 + r;
      L.bj = j;
    }
    d2 = d1;
    d1 = L.hc1[r];
    d12 = L.hc2[r];
    L.hc2[r] = L.hc1[r];
    L.hc1[r] = h;
    L.f[r] = f;
    ecar = e;
  }
  L.up2 = L.up1;
  L.up1 = in_h;
  L.upb = in_h2;
  out[0] = L.hc1[K - 1];
  out[1] = L.hc1[K - 2];
  out[2] = ecar;
}

// Traceback bytes of one pair are stored by (pass, step, lane): lane t
// writes its K bytes of step s at ((pass*(lb+31) + s)*32 + t)*K, so a
// warp's stores of one step are contiguous.
SWL_HD size_t tb_pair_bytes(int la, int lb, int k) {
  const int npass = (la + WARP * k - 1) / (WARP * k);
  return (size_t)npass * (lb + WARP - 1) * WARP * k;
}

SWL_HD size_t tb_offset(int lb, int k, int pass, int step, int lane) {
  return (((size_t)pass * (lb + WARP - 1) + step) * WARP + lane) * k;
}

SWL_HD uint8_t tb_at(const uint8_t* tb, int lb, int k, int i, int j) {
  const int rows = WARP * k;
  const int t = (i % rows) / k;
  return tb[tb_offset(lb, k, i / rows, j + t, t) + i % k];
}

// Backward walk from the best cell (TraceBackBitSW, src/sw.cpp:8-77;
// ops/postalign_jax.walk_traceback_batch): path codes 1=M 2=D 3=I written
// backward from the alignment end, zero after its start.
SWL_HD void walk(const uint8_t* tb, int lb, int k, float best, int bi,
                 int bj, int max_steps, uint8_t* path, int* lo_a,
                 int* lo_b, int* plen) {
  int i = bi + 1, j = bj + 1, st = 0, n = 0;
  bool done = best <= 0.0f;
  while (!done && n < max_steps) {
    path[n++] = (uint8_t)(st + 1);
    if (st == 0) {
      const int t = tb_at(tb, lb, k, i - 1, j - 1) & 3;
      if (t == 3) {
        done = true;
      } else {
        st = t;
        --i;
        --j;
      }
    } else if (st == 1) {
      st = (tb_at(tb, lb, k, i, j) & 4) ? 0 : 1;
      --i;
    } else {
      st = (tb_at(tb, lb, k, i, j) & 8) ? 0 : 2;
      --j;
    }
  }
  *lo_a = i - 1;
  *lo_b = j - 1;
  *plen = n;
}

}  // namespace swl
