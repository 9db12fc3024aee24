// K3: exact k-nearest-neighbour search (k <= 8) without a (Q, N) matrix.
//
// Replaces the Pallas TPU kernel
//   lego_loam_tpu/ops/knn_pallas.py :: knn_pallas
// (plain counterpart: squared-distance matrix + top-k, lego_loam_tpu/ops/
// knn.py::knn with exact=True).  Each reference point is ranked by
// |r|^2 - 2 q.r (the per-query |q|^2 cannot change the order); invalid
// references carry a +1e30 offset in |r|^2 and rank last; ties go to the
// lower index.  The returned distance is that rank plus |q|^2, clamped at 0,
// with the invalid sentinel kept huge, as knn_pallas.py:131-135 does.
//
// What bounds it on an H100: FP32 issue rate.  At the mapping shapes (4096
// queries x 32768 map points) the work is 134 M candidate distances of 3
// FMAs plus a compare each, while the inputs are under 1 MB; the plain
// version instead writes and re-reads a 512 MB distance matrix and sorts it.
// K = 3 is far too small for tensor cores, and TF32 is ruled out anyway.
//
// What the design does about it: one thread per query keeps its sorted
// top-k list in registers (k is a template parameter, so the insertion
// network unrolls); each block stages reference tiles of
// (x, y, z, |r|^2 + invalid * 1e30) in shared memory, where every thread
// reads the same float4 (a broadcast).  Nothing is written but the (Q, k)
// outputs.  With 64 queries a block there are only 16-64 blocks at the
// mapping shapes, below one per SM; splitting N across blocks with a merge
// pass is the next step for occupancy.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float4* __restrict__ ref4,
           int Q, int N, int32_t* __restrict__ idx_out,
           float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < Q) {
    qx = query[3 * q + 0];
    qy = query[3 * q + 1];
    qz = query[3 * q + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  for (int base = 0; base < N; base += kTile) {
    const int nt = min(kTile, N - base);
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += kThreads) tile[j] = ref4[base + j];
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float4 r = tile[j];
      const float d = r.w - 2.0f * (qx * r.x + qy * r.y + qz * r.z);
      if (d < bd[K - 1]) {
        // sorted insert from the back; an equal entry stays in front
        const int id = base + j;
        bool placed = false;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (!placed) {
            if (bd[s - 1] > d) {
              bd[s] = bd[s - 1];
              bi[s] = bi[s - 1];
            } else {
              bd[s] = d;
              bi[s] = id;
              placed = true;
            }
          }
        }
        if (!placed) {
          bd[0] = d;
          bi[0] = id;
        }
      }
    }
  }

  if (q < Q) {
    const float qq = qx * qx + qy * qy + qz * qz;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float o = bd[s];
      d2_out[(size_t)q * K + s] = o >= 0.5e30f ? o : fmaxf(o + qq, 0.0f);
      idx_out[(size_t)q * K + s] = bi[s];
    }
  }
}

template <int K>
cudaError_t launch(const float* query, const float4* ref4, int Q, int N,
                   int32_t* idx, float* d2, cudaStream_t stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(query, ref4, Q, N, idx, d2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lego_knn(const float* query, const float* ref4, int Q, int N,
                        int k, int32_t* idx, float* d2, cudaStream_t stream) {
  if (Q < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const float4* r4 = reinterpret_cast<const float4*>(ref4);
  switch (k) {
    case 1: return (int)launch<1>(query, r4, Q, N, idx, d2, stream);
    case 2: return (int)launch<2>(query, r4, Q, N, idx, d2, stream);
    case 3: return (int)launch<3>(query, r4, Q, N, idx, d2, stream);
    case 4: return (int)launch<4>(query, r4, Q, N, idx, d2, stream);
    case 5: return (int)launch<5>(query, r4, Q, N, idx, d2, stream);
    case 6: return (int)launch<6>(query, r4, Q, N, idx, d2, stream);
    case 7: return (int)launch<7>(query, r4, Q, N, idx, d2, stream);
    case 8: return (int)launch<8>(query, r4, Q, N, idx, d2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
