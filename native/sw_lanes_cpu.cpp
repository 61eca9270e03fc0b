// Host build of the strip-wavefront kernels of sw_kernels.cu: the same
// lane code (sw_lanes.h), with the warp's 32 lanes run one after another
// each step and the shuffle replaced by the previous step's lane outputs.
// Used by the tests (ops/sw_cuda.py emulate_*) to check the kernels'
// arithmetic against the numpy reference where there is no card.

#include <string.h>

#include <vector>

#include "sw_lanes.h"

using namespace swl;

namespace {

template <int K>
float mu_pair(const uint8_t* a, const uint8_t* b, const int* tbl, int la,
              int lb, int open, int ext) {
  MuLane<K> lanes[WARP];
  int out[WARP][3], prev[WARP][3];
  std::vector<int> bnd(3 * (size_t)lb, MU_NEG);
  const int npass = (la + WARP * K - 1) / (WARP * K);
  for (int t = 0; t < WARP; ++t) lanes[t].best = 0;
  for (int p = 0; p < npass; ++p) {
    for (int t = 0; t < WARP; ++t) {
      mu_begin_pass(lanes[t], a, la, p * WARP * K + t * K);
      out[t][0] = out[t][1] = out[t][2] = MU_NEG;
    }
    for (int s = 0; s < lb + WARP - 1; ++s) {
      memcpy(prev, out, sizeof(out));
      for (int t = 0; t < WARP; ++t) {
        const int j = s - t;
        if (j < 0 || j >= lb) continue;
        int in[3];
        if (t > 0) {
          in[0] = prev[t - 1][0]; in[1] = prev[t - 1][1]; in[2] = prev[t - 1][2];
        } else if (p == 0) {
          in[0] = in[1] = in[2] = MU_NEG;
        } else {
          in[0] = bnd[j]; in[1] = bnd[lb + j]; in[2] = bnd[2 * lb + j];
        }
        mu_step(lanes[t], tbl, b[j], in[0], in[1], in[2], open, ext, out[t]);
        if (t == WARP - 1) {
          bnd[j] = out[t][0]; bnd[lb + j] = out[t][1]; bnd[2 * lb + j] = out[t][2];
        }
      }
    }
  }
  int best = 0;
  for (int t = 0; t < WARP; ++t) best = imax(best, lanes[t].best);
  return (float)best;
}

template <int K>
void aln_pair(const uint8_t* pa, const uint8_t* pb, const float* tbl,
              const int* meta, int nf, int la, int lb, float open, float ext,
              float* best, int* bi, int* bj, int* lo_a, int* lo_b,
              int* plen, uint8_t* path, uint8_t* tb) {
  const int* base = meta;
  const int* stride = meta + MAX_FEATURES;
  const uint32_t pad0 = (uint32_t)meta[2 * MAX_FEATURES];
  const uint32_t pad1 = (uint32_t)meta[2 * MAX_FEATURES + 1];
  AlnLane<K> lanes[WARP];
  float out[WARP][3], prev[WARP][3];
  std::vector<float> bnd(3 * (size_t)lb, NEG);
  const int npass = (la + WARP * K - 1) / (WARP * K);
  for (int t = 0; t < WARP; ++t) {
    lanes[t].best = 0.0f;
    lanes[t].bi = lanes[t].bj = 0;
  }
  for (int p = 0; p < npass; ++p) {
    for (int t = 0; t < WARP; ++t) {
      aln_begin_pass(lanes[t], pa, la, p * WARP * K + t * K, pad0, pad1);
      out[t][0] = out[t][1] = out[t][2] = NEG;
    }
    for (int s = 0; s < lb + WARP - 1; ++s) {
      memcpy(prev, out, sizeof(out));
      for (int t = 0; t < WARP; ++t) {
        const int j = s - t;
        if (j < 0 || j >= lb) continue;
        float in[3];
        if (t > 0) {
          in[0] = prev[t - 1][0]; in[1] = prev[t - 1][1]; in[2] = prev[t - 1][2];
        } else if (p == 0) {
          in[0] = in[1] = in[2] = NEG;
        } else {
          in[0] = bnd[j]; in[1] = bnd[lb + j]; in[2] = bnd[2 * lb + j];
        }
        const uint8_t* c = pb + (size_t)j * MAX_FEATURES;
        const uint32_t b0 = c[0] | (c[1] << 8) | (c[2] << 16) | ((uint32_t)c[3] << 24);
        const uint32_t b1 = c[4] | (c[5] << 8) | (c[6] << 16) | ((uint32_t)c[7] << 24);
        uint32_t tbw[K / 4];
        aln_step(lanes[t], tbl, base, stride, nf, b0, b1, in[0], in[1], in[2],
                 open, ext, p * WARP * K + t * K, j, out[t], tbw);
        memcpy(tb + tb_offset(lb, K, p, s, t), tbw, K);
        if (t == WARP - 1) {
          bnd[j] = out[t][0]; bnd[lb + j] = out[t][1]; bnd[2 * lb + j] = out[t][2];
        }
      }
    }
  }
  float bv = 0.0f;
  int bi_ = 0, bj_ = 0;
  for (int t = 0; t < WARP; ++t) {
    if (better(lanes[t].best, lanes[t].bi, lanes[t].bj, bv, bi_, bj_)) {
      bv = lanes[t].best; bi_ = lanes[t].bi; bj_ = lanes[t].bj;
    }
  }
  *best = bv; *bi = bi_; *bj = bj_;
  const int max_steps = la + lb;
  memset(path, 0, max_steps);
  walk(tb, lb, K, bv, bi_, bj_, max_steps, path, lo_a, lo_b, plen);
}

}  // namespace

extern "C" {

int swl_lanes_k(int la) { return lanes_k(la); }

long long swl_tb_pair_bytes(int la, int lb) {
  return (long long)tb_pair_bytes(la, lb, lanes_k(la));
}

void swl_mu_scores(const uint8_t* a, const uint8_t* b, const int* tbl, int n,
                   int la, int lb, int open, int ext, float* out) {
  for (int p = 0; p < n; ++p) {
    const uint8_t* ap = a + (size_t)p * la;
    const uint8_t* bp = b + (size_t)p * lb;
    switch (lanes_k(la)) {
      case 4: out[p] = mu_pair<4>(ap, bp, tbl, la, lb, open, ext); break;
      case 8: out[p] = mu_pair<8>(ap, bp, tbl, la, lb, open, ext); break;
      default: out[p] = mu_pair<16>(ap, bp, tbl, la, lb, open, ext); break;
    }
  }
}

void swl_align(const uint8_t* pa, const uint8_t* pb, const float* tbl,
               const int* meta, int nf, int n, int la, int lb, float open,
               float ext, float* best, int* bi, int* bj, int* lo_a, int* lo_b,
               int* plen, uint8_t* path, uint8_t* tb) {
  const size_t tbp = tb_pair_bytes(la, lb, lanes_k(la));
  for (int p = 0; p < n; ++p) {
    const uint8_t* a = pa + (size_t)p * la * MAX_FEATURES;
    const uint8_t* b = pb + (size_t)p * lb * MAX_FEATURES;
    uint8_t* pp = path + (size_t)p * (la + lb);
    uint8_t* tp = tb + (size_t)p * tbp;
    switch (lanes_k(la)) {
      case 4:
        aln_pair<4>(a, b, tbl, meta, nf, la, lb, open, ext, best + p, bi + p,
                    bj + p, lo_a + p, lo_b + p, plen + p, pp, tp);
        break;
      case 8:
        aln_pair<8>(a, b, tbl, meta, nf, la, lb, open, ext, best + p, bi + p,
                    bj + p, lo_a + p, lo_b + p, plen + p, pp, tp);
        break;
      default:
        aln_pair<16>(a, b, tbl, meta, nf, la, lb, open, ext, best + p,
                     bi + p, bj + p, lo_a + p, lo_b + p, plen + p, pp, tp);
        break;
    }
  }
}

}  // extern "C"
