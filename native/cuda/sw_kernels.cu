// Hopper Smith-Waterman kernels called from JAX through the XLA FFI
// (ops/sw_cuda.py):
//
//   ReseekMuSweep  best local Mu-filter scores (integer 37x37 table,
//                  src/parasail_mu.cpp recurrences) for a batch of pairs
//   ReseekSwAlign  full-profile SW with traceback bits, best cell and the
//                  backward path walk (stage 3; bit-exact to ops/sw_np.py)
//
// One warp per pair; the lane code and the layout of the traceback bytes
// are in ../sw_lanes.h.  The substitution score of each cell is looked up
// in a table held in shared memory, so no [B, LA, LB] substitution tensor
// is ever written to device memory.
//
// Build: reseek_tpu/native_build.py (nvcc, sm_90a).

#include <cuda_runtime.h>

#include "../sw_lanes.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace swl;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;

template <typename T>
__device__ __forceinline__ T warp_up(T v) {
  return __shfl_up_sync(FULL, v, 1);
}

template <int K>
__global__ void mu_sweep_kernel(const uint8_t* __restrict__ a,
                                const uint8_t* __restrict__ b,
                                const int* __restrict__ tbl_g, int n, int la,
                                int lb, int open, int ext,
                                float* __restrict__ out_g,
                                int* __restrict__ bnd_g) {
  __shared__ int tbl[MU_ALPHA * MU_ALPHA];
  for (int k = threadIdx.x; k < MU_ALPHA * MU_ALPHA; k += blockDim.x)
    tbl[k] = tbl_g[k];
  __syncthreads();
  const int lane = threadIdx.x & (WARP - 1);
  const int pair = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
  if (pair >= n) return;  // warp-uniform
  const uint8_t* ap = a + (size_t)pair * la;
  const uint8_t* bp = b + (size_t)pair * lb;
  int* bnd = bnd_g + (size_t)pair * 3 * lb;
  MuLane<K> L;
  L.best = 0;
  const int npass = (la + WARP * K - 1) / (WARP * K);
  for (int p = 0; p < npass; ++p) {
    mu_begin_pass(L, ap, la, p * WARP * K + lane * K);
    int out[3] = {MU_NEG, MU_NEG, MU_NEG};
    for (int s = 0; s < lb + WARP - 1; ++s) {
      int in0 = warp_up(out[0]);
      int in1 = warp_up(out[1]);
      int in2 = warp_up(out[2]);
      const int j = s - lane;
      if (j >= 0 && j < lb) {
        if (lane == 0) {
          if (p == 0) {
            in0 = in1 = in2 = MU_NEG;
          } else {
            in0 = bnd[j];
            in1 = bnd[lb + j];
            in2 = bnd[2 * lb + j];
          }
        }
        mu_step(L, tbl, bp[j], in0, in1, in2, open, ext, out);
        if (lane == WARP - 1 && p + 1 < npass) {
          bnd[j] = out[0];
          bnd[lb + j] = out[1];
          bnd[2 * lb + j] = out[2];
        }
      }
    }
    __syncwarp();
  }
  int best = L.best;
  for (int off = WARP / 2; off > 0; off >>= 1)
    best = imax(best, __shfl_down_sync(FULL, best, off));
  if (lane == 0) out_g[pair] = (float)best;
}

// one vector store of a lane's K traceback bytes (K/4 packed words)
template <int K>
__device__ __forceinline__ void store_tb(uint8_t* dst, const uint32_t* w) {
  if constexpr (K == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (K == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

template <int K>
__global__ void sw_align_kernel(
    const uint8_t* __restrict__ pa, const uint8_t* __restrict__ pb,
    const float* __restrict__ tbl_g, const int* __restrict__ meta_g,
    int ntbl, int nf, int n, int la, int lb, float open, float ext,
    float* __restrict__ best_g, int* __restrict__ bi_g,
    int* __restrict__ bj_g, int* __restrict__ lo_a_g,
    int* __restrict__ lo_b_g, int* __restrict__ plen_g,
    uint8_t* __restrict__ path_g, uint8_t* __restrict__ tb_g,
    float* __restrict__ bnd_g) {
  extern __shared__ float tbl[];
  __shared__ int base[MAX_FEATURES], stride[MAX_FEATURES];
  for (int k = threadIdx.x; k < ntbl; k += blockDim.x) tbl[k] = tbl_g[k];
  if (threadIdx.x < MAX_FEATURES) {
    base[threadIdx.x] = meta_g[threadIdx.x];
    stride[threadIdx.x] = meta_g[MAX_FEATURES + threadIdx.x];
  }
  __syncthreads();
  const uint32_t pad0 = (uint32_t)meta_g[2 * MAX_FEATURES];
  const uint32_t pad1 = (uint32_t)meta_g[2 * MAX_FEATURES + 1];
  const int lane = threadIdx.x & (WARP - 1);
  const int pair = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
  if (pair >= n) return;  // warp-uniform
  const uint8_t* ap = pa + (size_t)pair * la * MAX_FEATURES;
  const uint8_t* bp = pb + (size_t)pair * lb * MAX_FEATURES;
  uint8_t* tb = tb_g + (size_t)pair * tb_pair_bytes(la, lb, K);
  float* bnd = bnd_g + (size_t)pair * 3 * lb;
  AlnLane<K> L;
  L.best = 0.0f;
  L.bi = L.bj = 0;
  const int npass = (la + WARP * K - 1) / (WARP * K);
  for (int p = 0; p < npass; ++p) {
    const int i0 = p * WARP * K + lane * K;
    aln_begin_pass(L, ap, la, i0, pad0, pad1);
    float out[3] = {NEG, NEG, NEG};
    for (int s = 0; s < lb + WARP - 1; ++s) {
      float in0 = warp_up(out[0]);
      float in1 = warp_up(out[1]);
      float in2 = warp_up(out[2]);
      const int j = s - lane;
      if (j >= 0 && j < lb) {
        if (lane == 0) {
          if (p == 0) {
            in0 = in1 = in2 = NEG;
          } else {
            in0 = bnd[j];
            in1 = bnd[lb + j];
            in2 = bnd[2 * lb + j];
          }
        }
        const uint2 bc =
            *reinterpret_cast<const uint2*>(bp + (size_t)j * MAX_FEATURES);
        uint32_t tbw[K / 4];
        aln_step(L, tbl, base, stride, nf, bc.x, bc.y, in0, in1, in2, open,
                 ext, i0, j, out, tbw);
        store_tb<K>(tb + tb_offset(lb, K, p, s, lane), tbw);
        if (lane == WARP - 1 && p + 1 < npass) {
          bnd[j] = out[0];
          bnd[lb + j] = out[1];
          bnd[2 * lb + j] = out[2];
        }
      }
    }
    __syncwarp();
  }
  float best = L.best;
  int bi = L.bi, bj = L.bj;
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(FULL, best, off);
    const int oi = __shfl_down_sync(FULL, bi, off);
    const int oj = __shfl_down_sync(FULL, bj, off);
    if (better(ob, oi, oj, best, bi, bj)) {
      best = ob;
      bi = oi;
      bj = oj;
    }
  }
  const int max_steps = la + lb;
  uint8_t* path = path_g + (size_t)pair * max_steps;
  int plen = 0;
  if (lane == 0) {
    int lo_a, lo_b;
    walk(tb, lb, K, best, bi, bj, max_steps, path, &lo_a, &lo_b, &plen);
    best_g[pair] = best;
    bi_g[pair] = bi;
    bj_g[pair] = bj;
    lo_a_g[pair] = lo_a;
    lo_b_g[pair] = lo_b;
    plen_g[pair] = plen;
  }
  plen = __shfl_sync(FULL, plen, 0);
  for (int k = plen + lane; k < max_steps; k += WARP) path[k] = 0;
}

int blocks_for(int n) {
  return (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

ffi::Error launch_error() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error MuSweepImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> a,
                       ffi::Buffer<ffi::U8> b, ffi::Buffer<ffi::S32> tbl,
                       int32_t open, int32_t ext,
                       ffi::ResultBuffer<ffi::F32> out,
                       ffi::ResultBuffer<ffi::S32> bnd) {
  const auto da = a.dimensions();
  const auto db = b.dimensions();
  if (da.size() != 2 || db.size() != 2 || da[0] != db[0] ||
      tbl.element_count() != MU_ALPHA * MU_ALPHA)
    return ffi::Error::InvalidArgument("mu_sweep: bad shapes");
  const int n = (int)da[0], la = (int)da[1], lb = (int)db[1];
  if (n == 0) return ffi::Error::Success();
  const dim3 grid(blocks_for(n)), block(WARPS_PER_BLOCK * WARP);
#define MU_LAUNCH(K)                                                     \
  mu_sweep_kernel<K><<<grid, block, 0, stream>>>(                        \
      a.typed_data(), b.typed_data(), tbl.typed_data(), n, la, lb, open, \
      ext, out->typed_data(), bnd->typed_data())
  switch (lanes_k(la)) {
    case 4: MU_LAUNCH(4); break;
    case 8: MU_LAUNCH(8); break;
    default: MU_LAUNCH(16); break;
  }
#undef MU_LAUNCH
  return launch_error();
}

ffi::Error SwAlignImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> pa,
                       ffi::Buffer<ffi::U8> pb, ffi::Buffer<ffi::F32> tbl,
                       ffi::Buffer<ffi::S32> meta, float open, float ext,
                       int32_t nf, ffi::ResultBuffer<ffi::F32> best,
                       ffi::ResultBuffer<ffi::S32> bi,
                       ffi::ResultBuffer<ffi::S32> bj,
                       ffi::ResultBuffer<ffi::S32> lo_a,
                       ffi::ResultBuffer<ffi::S32> lo_b,
                       ffi::ResultBuffer<ffi::S32> plen,
                       ffi::ResultBuffer<ffi::U8> path,
                       ffi::ResultBuffer<ffi::U8> tb,
                       ffi::ResultBuffer<ffi::F32> bnd) {
  const auto da = pa.dimensions();
  const auto db = pb.dimensions();
  if (da.size() != 3 || db.size() != 3 || da[0] != db[0] ||
      da[2] != MAX_FEATURES || db[2] != MAX_FEATURES || nf < 1 ||
      nf > MAX_FEATURES || meta.element_count() != 2 * MAX_FEATURES + 2)
    return ffi::Error::InvalidArgument("sw_align: bad shapes");
  const int n = (int)da[0], la = (int)da[1], lb = (int)db[1];
  if (n == 0) return ffi::Error::Success();
  const int ntbl = (int)tbl.element_count();
  const size_t smem = (size_t)ntbl * sizeof(float);
  const dim3 grid(blocks_for(n)), block(WARPS_PER_BLOCK * WARP);
#define ALN_LAUNCH(K)                                                        \
  sw_align_kernel<K><<<grid, block, smem, stream>>>(                         \
      pa.typed_data(), pb.typed_data(), tbl.typed_data(), meta.typed_data(), \
      ntbl, nf, n, la, lb, open, ext, best->typed_data(),                    \
      bi->typed_data(), bj->typed_data(), lo_a->typed_data(),                \
      lo_b->typed_data(), plen->typed_data(), path->typed_data(),            \
      tb->typed_data(), bnd->typed_data())
  switch (lanes_k(la)) {
    case 4: ALN_LAUNCH(4); break;
    case 8: ALN_LAUNCH(8); break;
    default: ALN_LAUNCH(16); break;
  }
#undef ALN_LAUNCH
  return launch_error();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ReseekMuSweep, MuSweepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("open")
                                  .Attr<int32_t>("ext")
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(ReseekSwAlign, SwAlignImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<float>("open")
                                  .Attr<float>("ext")
                                  .Attr<int32_t>("nf")
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
