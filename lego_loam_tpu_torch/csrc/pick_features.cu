// K2: the feature-pick loops (corner pass, then surf pass) in one launch.
//
// Replaces the Pallas TPU kernel
//   lego_loam_tpu/ops/features_pallas.py :: pick_features_pallas
// (plain counterpart: the sector_parallel pick loop of
// lego_loam_tpu/ops/features.py::label_features).  Per step, every sector of
// every ring takes the masked argmax (corner pass: curvature, labels 2 for
// the first n_sharp steps then 1) or argmin (surf pass: labels -1) over its
// eligible, not-yet-picked cells, ties to the lowest index; then each pick
// marks its precomputed +-reach band picked.  All sectors of a step read the
// same `picked` snapshot.
//
// What bounds it on an H100: latency.  The data is 16 x 1800 cells (~0.4 MB
// in all) and the work is 24 dependent argmax steps; a version made of
// separate tensor ops pays several launches and a device-memory round trip
// per step.
//
// What the design does about it: one thread block per ring (rings are
// independent) holds its ring in shared memory (13 bytes a cell, ~23 KB)
// and runs all steps of both passes in sequence.  One warp per sector finds
// its argmax with a strided scan and a shuffle reduction that breaks ties to
// the lower index; a __syncthreads between the argmax phase and the
// label/band phase gives every sector the same snapshot.  Integer outputs
// match the plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void argbest(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void pick_kernel(const float* __restrict__ curv,
                            const uint8_t* __restrict__ corner_base,
                            const uint8_t* __restrict__ surf_base,
                            const uint8_t* __restrict__ picked0,
                            const int32_t* __restrict__ reach_l,
                            const int32_t* __restrict__ reach_r,
                            const int32_t* __restrict__ sp_all,
                            const int32_t* __restrict__ ep_all,
                            const uint8_t* __restrict__ ok_all,
                            int32_t* __restrict__ labels_out,
                            uint8_t* __restrict__ picked_out, int W, int S,
                            int n_corner, int n_sharp, int n_surf) {
  extern __shared__ unsigned char sm[];
  float* s_curv = reinterpret_cast<float*>(sm);
  int32_t* s_lab = reinterpret_cast<int32_t*>(s_curv + W);
  uint8_t* s_pick = reinterpret_cast<uint8_t*>(s_lab + W);
  uint8_t* s_cb = s_pick + W;
  uint8_t* s_sb = s_cb + W;
  uint8_t* s_rl = s_sb + W;
  uint8_t* s_rr = s_rl + W;
  __shared__ int s_idx[32];

  const int r = blockIdx.x;
  const size_t row = (size_t)r * W;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    s_curv[c] = curv[row + c];
    s_lab[c] = 0;
    s_pick[c] = picked0[row + c] ? 1 : 0;
    s_cb[c] = corner_base[row + c];
    s_sb[c] = surf_base[row + c];
    s_rl[c] = (uint8_t)reach_l[row + c];
    s_rr[c] = (uint8_t)reach_r[row + c];
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sp = sp_all[r * S + warp];
  const int ep = ep_all[r * S + warp];
  const bool ok = ok_all[r * S + warp] != 0;
  __syncthreads();

  for (int pass = 0; pass < 2; ++pass) {
    const uint8_t* base = pass == 0 ? s_cb : s_sb;
    const float sign = pass == 0 ? 1.0f : -1.0f;
    const int n_picks = pass == 0 ? n_corner : n_surf;
    for (int k = 0; k < n_picks; ++k) {
      // argmax phase: every sector against the same `picked` snapshot
      float best = -INFINITY;
      int bi = 0x7fffffff;
      if (ok) {
        for (int c = sp + lane; c <= ep; c += 32) {
          if (base[c] && !s_pick[c]) {
            const float v = sign * s_curv[c];
            if (v > best) {  // ascending c per lane: keeps the first
              best = v;
              bi = c;
            }
          }
        }
      }
      argbest(best, bi);
      if (lane == 0) s_idx[warp] = bi;
      __syncthreads();
      // label + suppression band phase
      const int idx = s_idx[warp];
      if (idx != 0x7fffffff) {
        if (lane == 0) s_lab[idx] = pass == 0 ? (k < n_sharp ? 2 : 1) : -1;
        const bool sup = pass == 0 || k < n_picks - 1;
        if (sup) {
          const int lo = max(idx - (int)s_rl[idx], 0);
          const int hi = min(idx + (int)s_rr[idx], W - 1);
          for (int c = lo + lane; c <= hi; c += 32) s_pick[c] = 1;
        }
      }
      __syncthreads();
    }
  }

  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    labels_out[row + c] = s_lab[c];
    picked_out[row + c] = s_pick[c];
  }
}

}  // namespace

extern "C" int lego_pick_features(const float* curv, const uint8_t* corner_base,
                                  const uint8_t* surf_base, const uint8_t* picked0,
                                  const int32_t* reach_l, const int32_t* reach_r,
                                  const int32_t* sp_all, const int32_t* ep_all,
                                  const uint8_t* ok_all, int32_t* labels,
                                  uint8_t* picked, int R, int W, int S,
                                  int n_corner, int n_sharp, int n_surf,
                                  cudaStream_t stream) {
  if (S < 1 || S > 32 || R < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * 13;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pick_kernel<<<R, 32 * S, smem, stream>>>(
      curv, corner_base, surf_base, picked0, reach_l, reach_r, sp_all, ep_all,
      ok_all, labels, picked, W, S, n_corner, n_sharp, n_surf);
  return (int)cudaGetLastError();
}
