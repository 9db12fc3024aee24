// K3: exact k-nearest-neighbour search (k <= 8) without a (Q, N) matrix.
//
// Replaces the Pallas TPU kernel
//   lego_loam_tpu/ops/knn_pallas.py :: knn_pallas
// (plain counterpart: squared-distance matrix + top-k, lego_loam_tpu/ops/
// knn.py::knn with exact=True).  Each reference point is ranked by
// |r|^2 - 2 q.r (the per-query |q|^2 cannot change the order); an invalid
// reference is staged as (0, 0, 0, 1e30), so it ranks exactly 1e30, last;
// ties go to the lower index.  The returned distance is that rank plus
// |q|^2, clamped at 0, with the invalid sentinel kept huge, as
// knn_pallas.py:131-135 does.
//
// What bounds it on an H100: FP32 issue rate.  At the mapping shapes (4096
// queries x 32768 map points) the work is 134 M candidate distances of 8
// flops, 1.07 GFLOP, ~0.016 ms at 67 TFLOP/s, while the inputs and outputs
// are 0.74 MB (0.2 us at 3.35 TB/s); the plain version instead writes and
// re-reads a 512 MB distance matrix and sorts it.  K = 3 is far too small for
// tensor cores, and TF32 is ruled out anyway.
//
// What the design does about it: every SM busy, a candidate kept to 3 FMAs
// and a compare, and no work on what cannot change a list.
//  * Pass 1 (knn_split_kernel) runs a grid of query tiles x reference
//    splits x problems (a batch of B independent searches, models/batch.py,
//    one launch); the wrapper picks the most splits S that keep the grid
//    within one wave of 4 blocks per SM, each split at least 256 references
//    long (ops/knn.py::knn_splits).  The split does not change the result:
//    the top-k with ties to the lower index is unique.  Each block stages its split's
//    (x, y, z, |r|^2) float4 tiles in shared memory, built from the (N, 3)
//    points and the validity mask as it loads them (no preparing launch),
//    where every thread reads the same float4 (a broadcast).  Of a tile
//    without a valid reference only the first k are ranked: the rest tie
//    with them at 1e30 and lose on index.
//  * One query a thread, its sorted top-k list in registers (k is a template
//    parameter, so the insertion unrolls).  The ranks of kChunk references
//    are computed before any compare, so their FMA chains overlap, and one
//    branch per chunk skips the chunk when no rank beats its list's tail.
//    Insertions stay the main cost above the scan: a split's list takes
//    ~k (1 + ln(split / k)) of them, and a warp waits for each one any of its
//    32 lanes makes.
//  * Pass 2 (knn_merge_kernel), one thread per query of each problem, merges
//    the S sorted lists of (rank, index) from scratch (B, S, k, Q) in split
//    order, which
//    gives lax.top_k's lowest-index rule across splits, then applies the
//    |q|^2 / clamp / sentinel epilogue, each winner evaluated again in the
//    plain version's rounding order (see finish).  With S = 1 pass 1 writes
//    the final output and pass 2 is skipped.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // pass 1 threads (queries) a block (ops/knn.py)
constexpr int kTile = 1024;          // float4 references staged at once
constexpr int kChunk = 8;            // references ranked before their compares
constexpr int kMergeThreads = 128;   // pass 2 threads (queries) a block
constexpr int kMergeGroup = 4;       // splits whose lists pass 2 loads at once
constexpr float kInvalid = 1e30f;    // an invalid reference's rank
constexpr float kSentinel = 0.5e30f;

// Sorted insert of (d, id), d < bd[K-1], without a branch: every slot picks
// its new entry at once.  d goes in front of the first entry it is strictly
// below, so an equal entry stays in front: with candidates in ascending
// index order, ties keep the lower index.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int id) {
  bool lt[K];
#pragma unroll
  for (int s = 0; s < K; ++s) lt[s] = d < bd[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    bd[s] = lt[s - 1] ? bd[s - 1] : (lt[s] ? d : bd[s]);
    bi[s] = lt[s - 1] ? bi[s - 1] : (lt[s] ? id : bi[s]);
  }
  bd[0] = lt[0] ? d : bd[0];
  bi[0] = lt[0] ? id : bi[0];
}

// |(a, b, c)|^2 rounded as torch.sum adds three squares: (a^2 + c^2) + b^2.
__device__ __forceinline__ float sum_sq(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c)), __fmul_rn(b, b));
}

// A winner's returned distance: its rank plus |q|^2, clamped at 0, with the
// invalid sentinel kept.  That sum cancels ~|q|^2 (2500 at 50 m, where a
// float ulp is 2.4e-4), so any rounding order leaves a few ulps of |q|^2 in a
// distance of a few cm^2.  The k winners are therefore evaluated again from
// the points in the plain version's order, (|q|^2 + |r|^2) - (2 q) . r with
// one FMA chain for the dot product (cuBLAS's): equal to its distances to
// the bit on nearly every slot (chip_smoke.py prints the share).
__device__ __forceinline__ float finish(float rank, int id,
                                        const float* __restrict__ query,
                                        const float* __restrict__ ref, int q) {
  if (rank >= kSentinel) return rank;
  const float x = query[3 * q + 0], y = query[3 * q + 1], z = query[3 * q + 2];
  const float rx = ref[3 * id + 0], ry = ref[3 * id + 1], rz = ref[3 * id + 2];
  const float dot =
      __fmaf_rn(2.f * z, rz, __fmaf_rn(2.f * y, ry, __fmul_rn(2.f * x, rx)));
  return fmaxf(__fsub_rn(__fadd_rn(sum_sq(x, y, z), sum_sq(rx, ry, rz)), dot),
               0.0f);
}

// Block (x, y): queries [x * kThreads, +kThreads), references
// [y * split, +split).  Writes each query's sorted k best of the split: with
// S = gridDim.y > 1 the raw ranks to out[(y * K + slot) * Q + q] (coalesced
// stores), with S = 1 the final distances to out[q * K + slot].
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_split_kernel(const float* __restrict__ query,
                 const float* __restrict__ ref,
                 const uint8_t* __restrict__ ref_valid, int Q, int N, int split,
                 float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  __shared__ float4 tile[kTile + kChunk];     // + the prefetch's overrun
  const int S = gridDim.y;
  {  // problem blockIdx.z of the batch
    const size_t b = blockIdx.z;
    query += b * Q * 3;
    ref += b * N * 3;
    ref_valid += b * N;
    out_d += b * Q * S * K;
    out_i += b * Q * S * K;
  }
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int r0 = blockIdx.y * split;
  const int r1 = min(N, r0 + split);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < Q) {                  // rank = |r|^2 + (-2 q) . r
    qx = -2.0f * query[3 * q + 0];
    qy = -2.0f * query[3 * q + 1];
    qz = -2.0f * query[3 * q + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  for (int base = r0; base < r1; base += kTile) {
    const int nt = min(kTile, r1 - base);
    int nc = (nt + kChunk - 1) / kChunk * kChunk;
    __syncthreads();
    bool valid = false;
#pragma unroll 4
    for (int j = threadIdx.x; j < nt; j += kThreads) {
      const int g = base + j;
      const float x = ref[3 * g + 0], y = ref[3 * g + 1], z = ref[3 * g + 2];
      const bool ok = ref_valid[g];
      tile[j] = ok ? make_float4(x, y, z, x * x + y * y + z * z)
                   : make_float4(0.f, 0.f, 0.f, kInvalid);
      valid |= ok;
    }
    // pad to whole chunks with references that rank +inf, never taken
    if (threadIdx.x < nc - nt)
      tile[nt + threadIdx.x] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    // An invalid reference is (0, 0, 0, 1e30) and ranks exactly 1e30, so of
    // a tile without a valid one only the first K can enter a list.
    if (!__syncthreads_or(valid)) nc = min(nc, (K + kChunk - 1) / kChunk * kChunk);
    float4 next[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) next[u] = tile[u];
    for (int j = 0; j < nc; j += kChunk) {
      float d[kChunk];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4 r = next[u];
        next[u] = tile[j + kChunk + u];
        d[u] = fmaf(qx, r.x, fmaf(qy, r.y, fmaf(qz, r.z, r.w)));
        any |= d[u] < bd[K - 1];
      }
      if (any) {        // the list only shrinks: a chunk-miss holds no insertion
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (d[u] < bd[K - 1]) insert<K>(bd, bi, d[u], base + j + u);
      }
    }
  }

  if (q >= Q) return;
  if (S == 1) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[(size_t)q * K + s] = finish(bd[s], bi[s], query, ref, q);
      out_i[(size_t)q * K + s] = bi[s];
    }
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[((size_t)blockIdx.y * K + s) * Q + q] = bd[s];
      out_i[((size_t)blockIdx.y * K + s) * Q + q] = bi[s];
    }
  }
}

// One thread per query merges the S sorted lists in split order, so an
// equal rank keeps the earlier split's, lower, index; each list is read only
// while it beats the running k-th best.  Loads are coalesced across threads
// and kMergeGroup splits' lists are in flight at once.
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ query,
                 const float* __restrict__ ref,
                 const float* __restrict__ part_d,
                 const int32_t* __restrict__ part_i, int N, int Q, int S,
                 int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  {  // problem blockIdx.y of the batch
    const size_t b = blockIdx.y;
    query += b * Q * 3;
    ref += b * N * 3;
    part_d += b * Q * S * K;
    part_i += b * Q * S * K;
    idx_out += b * Q * K;
    d2_out += b * Q * K;
  }
  const int q = blockIdx.x * kMergeThreads + threadIdx.x;
  if (q >= Q) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }
  for (int s0 = 0; s0 < S; s0 += kMergeGroup) {
    float d[kMergeGroup][K];
    int id[kMergeGroup][K];
#pragma unroll
    for (int g = 0; g < kMergeGroup; ++g) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const size_t o = ((size_t)(s0 + g) * K + s) * Q + q;
        const bool in = s0 + g < S;
        d[g][s] = in ? part_d[o] : CUDART_INF_F;
        id[g][s] = in ? part_i[o] : 0;
      }
    }
#pragma unroll
    for (int g = 0; g < kMergeGroup; ++g) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (!(d[g][s] < bd[K - 1])) break;   // the rest of this list ranks lower
        insert<K>(bd, bi, d[g][s], id[g][s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d2_out[(size_t)q * K + s] = finish(bd[s], bi[s], query, ref, q);
    idx_out[(size_t)q * K + s] = bi[s];
  }
}

template <int K>
cudaError_t launch(const float* query, const float* ref, const uint8_t* valid,
                   int B, int Q, int N, int S,
                   float* scratch, int32_t* idx, float* d2,
                   cudaStream_t stream) {
  const int split = (N + S - 1) / S;
  const dim3 grid((Q + kThreads - 1) / kThreads, S, B);
  if (S == 1) {
    knn_split_kernel<K><<<grid, kThreads, 0, stream>>>(query, ref, valid, Q,
                                                       N, split, d2, idx);
    return cudaGetLastError();
  }
  float* part_d = scratch;
  int32_t* part_i = reinterpret_cast<int32_t*>(scratch + (size_t)B * Q * S * K);
  knn_split_kernel<K><<<grid, kThreads, 0, stream>>>(query, ref, valid, Q, N,
                                                     split, part_d, part_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<K><<<dim3((Q + kMergeThreads - 1) / kMergeThreads, B),
                        kMergeThreads, 0, stream>>>(query, ref, part_d, part_i,
                                                    N, Q, S, idx, d2);
  return cudaGetLastError();
}

}  // namespace

// B problems stored one after another: query (B, Q, 3), ref (B, N, 3),
// ref_valid (B, N), idx and d2 (B, Q, k).  scratch: 2 * B * S * k * Q 32-bit
// words (ranks, then indices); unused when S = 1.  Every split is
// [s * ceil(N / S), +ceil(N / S)) clipped to N.
extern "C" int lego_knn(const float* query, const float* ref,
                        const uint8_t* ref_valid, int B, int Q, int N,
                        int k, int S, float* scratch, int32_t* idx, float* d2,
                        cudaStream_t stream) {
  if (B < 1 || B > 65535 || Q < 1 || N < 1 || S < 1 || S > N || S > 65535 ||
      (S > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return (int)launch<1>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 2: return (int)launch<2>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 3: return (int)launch<3>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 4: return (int)launch<4>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 5: return (int)launch<5>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 6: return (int)launch<6>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 7: return (int)launch<7>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    case 8: return (int)launch<8>(query, ref, ref_valid, B, Q, N, S, scratch, idx,
                                      d2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
