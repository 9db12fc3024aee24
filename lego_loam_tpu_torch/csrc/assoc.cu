// K4: the odometry's scan-to-scan correspondence search without a (Q, N)
// matrix.
//
// Replaces no TPU kernel: the JAX package runs these searches in jnp
// (lego_loam_tpu/models/odometry.py::_assoc_corner, _assoc_surf,
// _assoc_surf_knn over lego_loam_tpu/ops/knn.py's sq_dist_matrix and
// masked_argmin), and so did the port, as a dense (Q, N) distance matrix
// and one masked copy of it for each pick: up to six eager passes over a
// matrix of 2048 x 16384 floats a sequence (HDL-64E), five association
// rounds a scan.  One launch computes every pick of one association for a batch of
// B searches (ops/assoc.py: slot 0 the nearest reference, slots 1-2 the two
// nearest in slot 0's ring, slots 3-4 the two nearest in a ring 1 or 2
// away, each optionally gated on the ground label).
//
// The picks are masked_argmin's, candidate for candidate: a reference's
// value is the plain version's max((|q|^2 + |r|^2) - (2 q) . r, 0), 1e30
// outside the category (so a slot with no candidate holds index 0 at
// 1e30, what argmin gives over a row of 1e30), candidates are taken in
// index order with strict compares (ties keep the lower index), and a NaN
// distance ranks below every number, the first NaN winning, as in
// torch.argmin.  Not a rank such as K3's |r|^2 - 2 q.r: the plain values
// clamp at 0, and clamped zeros must tie.  A distance of 1e30 or more
// counts as no candidate.
//
// What bounds it on an H100: the FP32 instruction rate.  A candidate is ~10
// operations a pass (the dot product's 3, two adds, the clamp, the NaN
// key, the gate, the compare and its selects) and the search reads each
// pair twice; at the HDL-64E fleet's shapes (B 64, 2048 x 16384 surf and
// 1024 x 8192 corner queries x references) that is 2.7 G pairs a round,
// ~0.8 ms at 67 TFLOP/s for both passes, while the inputs and outputs are
// ~30 MB (9 us at 3.35 TB/s).  Too few operations a pair for tensor cores,
// and TF32 would move the picks.
//
// What the design does about it: one query a thread, its picks in
// registers, and no work on references that cannot change them.
//  * The grid is query tiles x B, one launch for the batch; a block is 128
//    threads.  Where one query a thread would leave SMs idle (a single
//    sequence's search: 512 queries are 4 blocks), S = 2-32 lanes of a warp
//    share a query (ops/assoc.py::query_split), lane s taking references s,
//    s + S, ... in index order; the lanes then merge their picks by (value,
//    index) through shuffles, which is the order of the sequential scan, so
//    every S gives the same picks.
//  * The block stages kTile references at a time in shared memory, as a
//    float4 (x, y, z, |r|^2) and an int (ring << 2 | ground << 1 | valid)
//    that a warp reads together (one entry broadcast, or S neighbouring
//    ones, which fall in distinct banks), built from the (N, 3)
//    points and the masks as they are loaded (no preparing launch).  With
//    N <= kTile the tile stays for pass 2.  While staging, each warp
//    reduces its 32-reference chunk to the lowest and highest ring of its
//    valid references.
//  * Pass 1 keeps the best gated candidate and skips chunks without a
//    valid reference (the features' padding).  Pass 2 re-streams the
//    tiles with slot 0's ring in a register and keeps the same-ring and
//    adjacent-ring lists with branch-free inserts; a warp skips every
//    chunk whose rings lie more than 2 from all of its queries' slot-0
//    rings.  The features are stored ring by ring, so pass 2 reads ~5 rings
//    of the 16 or 64.
//  * No reference split across blocks and no merge launch: a fleet's grid
//    already holds ~1,000 blocks, a single search's lanes merge in
//    registers, and N is at most 16384 (HDL-64E's surf references).

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // a block (ops/assoc.py BLOCK_THREADS)
constexpr int kTile = 2048;        // references staged at once
constexpr int kChunk = 32;         // references one warp stages and skips together
constexpr int kChunks = kTile / kChunk;
constexpr int kSlots = 5;
constexpr float kNone = 1e30f;     // outside the category: the plain version's 1e30
constexpr unsigned kFull = 0xffffffffu;

// |(a, b, c)|^2 rounded as torch.sum adds three squares: (a^2 + c^2) + b^2.
__device__ __forceinline__ float sum_sq(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c)), __fmul_rn(b, b));
}

// The key of reference r for the query (|q|^2, 2 q): the plain version's
// distance, (|q|^2 + |r|^2) - (2 q) . r clamped at 0 (one FMA chain for the
// dot product, cuBLAS's), with a NaN as -1 so that a strict compare takes
// the first NaN before any number.
__device__ __forceinline__ float key_of(float qq, float qx2, float qy2, float qz2,
                                        float4 r) {
  const float dot = __fmaf_rn(qz2, r.z, __fmaf_rn(qy2, r.y, __fmul_rn(qx2, r.x)));
  float d = __fsub_rn(__fadd_rn(qq, r.w), dot);
  d = d < 0.f ? 0.f : d;           // a NaN stays
  return d == d ? d : -1.f;
}

__device__ __forceinline__ float value_of(float key) {
  return key < 0.f ? CUDART_NAN_F : key;
}

// Sorted insert of (d, id) into a list of K = 1 or 2 when `ok`, without a
// branch.  d goes in front of the first entry it is strictly below, so an
// equal entry stays in front: with candidates in ascending index order,
// ties keep the lower index.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], bool ok,
                                       float d, int id) {
  static_assert(K == 1 || K == 2, "lists of 1 or 2");
  const bool lt0 = ok && d < bd[0];
  if constexpr (K == 2) {
    const bool lt1 = ok && d < bd[1];
    bd[1] = lt0 ? bd[0] : (lt1 ? d : bd[1]);
    bi[1] = lt0 ? bi[0] : (lt1 ? id : bi[1]);
  }
  bd[0] = lt0 ? d : bd[0];
  bi[0] = lt0 ? id : bi[0];
}

// (d, i) comes before (e, j) in the sequential scan's order: the lower
// value, and of equal values the lower index.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Merges the sorted list of K = 1 or 2 with that of lane ^ m, both lanes
// ending with the same list.  The lanes' references are disjoint, so only
// the empty entries (1e30, 0) can be equal, and they tie harmlessly.
template <int K>
__device__ __forceinline__ void merge(float (&bd)[K], int (&bi)[K], int m) {
  float od[K];
  int oi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    od[s] = __shfl_xor_sync(kFull, bd[s], m);
    oi[s] = __shfl_xor_sync(kFull, bi[s], m);
  }
  const bool other = before(od[0], oi[0], bd[0], bi[0]);
  if constexpr (K == 2) {
    // the second: the loser's head or the winner's second
    const float ld = other ? bd[0] : od[0], wd = other ? od[1] : bd[1];
    const int li = other ? bi[0] : oi[0], wi = other ? oi[1] : bi[1];
    const bool lose = before(ld, li, wd, wi);
    bd[1] = lose ? ld : wd;
    bi[1] = lose ? li : wi;
  }
  bd[0] = other ? od[0] : bd[0];
  bi[0] = other ? oi[0] : bi[0];
}

struct Tile {
  float4 ref[kTile];
  int meta[kTile];     // ring << 2 | ground << 1 | valid; 0 past N
  int2 span[kChunks];  // lowest, highest ring of a chunk's valid references
};

// References [base, base + kTile) into the tile: warp w stages chunks w,
// w + warps, ..., lane l reference l of its chunk (coalesced), then the
// warp's reduction gives the chunk's span (lo > hi: no valid reference).
// Returns the tile's chunks that hold references.
__device__ __forceinline__ int stage(Tile& t, const float* __restrict__ ref,
                                     const uint8_t* __restrict__ ref_valid,
                                     const int32_t* __restrict__ ref_ring,
                                     const uint8_t* __restrict__ ref_ground,
                                     int N, int base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int n_chunks = min(kChunks, (N - base + kChunk - 1) / kChunk);
  for (int c = warp; c < n_chunks; c += warps) {
    const int j = c * kChunk + lane, g = base + j;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    int m = 0;
    if (g < N) {
      const float x = ref[3 * g + 0], y = ref[3 * g + 1], z = ref[3 * g + 2];
      r = make_float4(x, y, z, sum_sq(x, y, z));
      m = (ref_valid[g] ? 1 : 0) | (ref_ground && ref_ground[g] ? 2 : 0) |
          ref_ring[g] * 4;
    }
    t.ref[j] = r;
    t.meta[j] = m;
    const int ring = m >> 2;
    const int lo = __reduce_min_sync(kFull, (m & 1) ? ring : INT_MAX);
    const int hi = __reduce_max_sync(kFull, (m & 1) ? ring : INT_MIN);
    if (lane == 0) t.span[c] = make_int2(lo, hi);
  }
  return n_chunks;
}

// Block (x, y): queries [x * kThreads / S, +kThreads / S) of search y, S
// lanes a query.  NS same-ring and NA adjacent-ring picks (the kind); the
// other slots of those two get (0, 1e30).
template <int NS, int NA, int S>
__global__ void __launch_bounds__(kThreads)
assoc_kernel(const float* __restrict__ query, const float* __restrict__ ref,
             const uint8_t* __restrict__ ref_valid,
             const int32_t* __restrict__ ref_ring,
             const uint8_t* __restrict__ query_ground,
             const uint8_t* __restrict__ ref_ground, int Q, int N,
             int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  static_assert(S >= 1 && S <= 32 && (S & (S - 1)) == 0, "S lanes: 1, 2, 4, ..., 32");
  __shared__ Tile t;
  {  // search blockIdx.y of the batch
    const size_t b = blockIdx.y;
    query += b * Q * 3;
    ref += b * N * 3;
    ref_valid += b * N;
    ref_ring += b * N;
    if (query_ground != nullptr) {
      query_ground += b * Q;
      ref_ground += b * N;
    }
    idx_out += b * Q * kSlots;
    d2_out += b * Q * kSlots;
  }
  const int q = blockIdx.x * (kThreads / S) + threadIdx.x / S;
  const int sub = threadIdx.x % S;     // this lane's references: sub, sub + S, ...
  const bool live = q < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  // the meta bits a candidate shows: valid, and with the gate the query's
  // ground label
  int gmask = 1, gwant = 1;
  if (live) {
    qx = query[3 * q + 0];
    qy = query[3 * q + 1];
    qz = query[3 * q + 2];
    if (query_ground != nullptr) {
      gmask = 3;
      gwant = query_ground[q] ? 3 : 1;
    }
  }
  const float qq = sum_sq(qx, qy, qz);
  const float qx2 = 2.f * qx, qy2 = 2.f * qy, qz2 = 2.f * qz;

  // pass 1: slot 0
  float b0[1] = {kNone};
  int i0[1] = {0};
  int n_chunks = 0;
  for (int base = 0; base < N; base += kTile) {
    __syncthreads();
    n_chunks = stage(t, ref, ref_valid, ref_ring, ref_ground, N, base);
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      const int2 s = t.span[c];
      if (s.x > s.y) continue;           // no valid reference
#pragma unroll 8
      for (int v = 0; v < kChunk / S; ++v) {
        const int j = c * kChunk + v * S + sub;
        const float k = key_of(qq, qx2, qy2, qz2, t.ref[j]);
        const bool lt = (t.meta[j] & gmask) == gwant && k < b0[0];
        b0[0] = lt ? k : b0[0];
        i0[0] = lt ? base + j : i0[0];
      }
    }
  }
#pragma unroll
  for (int m = 1; m < S; m <<= 1) merge<1>(b0, i0, m);

  // pass 2: the ring lists around slot 0's ring
  const int r0 = ref_ring[i0[0]];
  const int wlo = __reduce_min_sync(kFull, live ? r0 : INT_MAX) - 2;
  const int whi = __reduce_max_sync(kFull, live ? r0 : INT_MIN) + 2;
  float bs[NS > 0 ? NS : 1], ba[NA];
  int is[NS > 0 ? NS : 1], ia[NA];
#pragma unroll
  for (int s = 0; s < (NS > 0 ? NS : 1); ++s) {
    bs[s] = kNone;
    is[s] = 0;
  }
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    ba[s] = kNone;
    ia[s] = 0;
  }
  for (int base = 0; base < N; base += kTile) {
    if (N > kTile) {                   // else pass 1's tile is still staged
      __syncthreads();
      n_chunks = stage(t, ref, ref_valid, ref_ring, ref_ground, N, base);
      __syncthreads();
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int2 s = t.span[c];
      if (s.y < wlo || s.x > whi) continue;   // warp-uniform: no ring in reach
#pragma unroll 8
      for (int v = 0; v < kChunk / S; ++v) {
        const int j = c * kChunk + v * S + sub, g = base + j;
        const int m = t.meta[j];
        const int dr = (m >> 2) - r0;
        const bool cand = (m & gmask) == gwant;
        const float k = key_of(qq, qx2, qy2, qz2, t.ref[j]);
        if constexpr (NS > 0) insert<NS>(bs, is, cand && dr == 0 && g != i0[0], k, g);
        insert<NA>(ba, ia, cand && dr != 0 && dr >= -2 && dr <= 2, k, g);
      }
    }
  }
#pragma unroll
  for (int m = 1; m < S; m <<= 1) {
    if constexpr (NS > 0) merge<NS>(bs, is, m);
    merge<NA>(ba, ia, m);
  }

  if (!live || sub != 0) return;
  int32_t* io = idx_out + (size_t)q * kSlots;
  float* dd = d2_out + (size_t)q * kSlots;
  io[0] = i0[0];
  dd[0] = value_of(b0[0]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const bool have_s = s < NS, have_a = s < NA;
    io[1 + s] = have_s ? is[have_s ? s : 0] : 0;
    dd[1 + s] = have_s ? value_of(bs[have_s ? s : 0]) : kNone;
    io[3 + s] = have_a ? ia[have_a ? s : 0] : 0;
    dd[3 + s] = have_a ? value_of(ba[have_a ? s : 0]) : kNone;
  }
}

template <int NS, int NA, int S>
cudaError_t launch(const float* query, const float* ref, const uint8_t* valid,
                   const int32_t* ring, const uint8_t* qg, const uint8_t* rg,
                   int B, int Q, int N, int32_t* idx, float* d2, cudaStream_t stream) {
  constexpr int per_block = kThreads / S;
  const dim3 grid((Q + per_block - 1) / per_block, B);
  assoc_kernel<NS, NA, S><<<grid, kThreads, 0, stream>>>(query, ref, valid, ring, qg,
                                                         rg, Q, N, idx, d2);
  return cudaGetLastError();
}

template <int NS, int NA>
cudaError_t launch_split(const float* query, const float* ref, const uint8_t* valid,
                         const int32_t* ring, const uint8_t* qg, const uint8_t* rg,
                         int B, int Q, int N, int split, int32_t* idx, float* d2,
                         cudaStream_t stream) {
  switch (split) {
    case 1: return launch<NS, NA, 1>(query, ref, valid, ring, qg, rg, B, Q, N, idx, d2, stream);
    case 2: return launch<NS, NA, 2>(query, ref, valid, ring, qg, rg, B, Q, N, idx, d2, stream);
    case 4: return launch<NS, NA, 4>(query, ref, valid, ring, qg, rg, B, Q, N, idx, d2, stream);
    case 8: return launch<NS, NA, 8>(query, ref, valid, ring, qg, rg, B, Q, N, idx, d2, stream);
    case 16: return launch<NS, NA, 16>(query, ref, valid, ring, qg, rg, B, Q, N, idx, d2, stream);
    case 32: return launch<NS, NA, 32>(query, ref, valid, ring, qg, rg, B, Q, N, idx, d2, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// B searches stored one after another: query (B, Q, 3), ref (B, N, 3),
// ref_valid and ref_ring (B, N), query_ground (B, Q) and ref_ground (B, N)
// both null (no class gate) or both given, idx and d2 (B, Q, 5).
// (n_same, n_adj) is the kind: (0, 1) corner, (1, 1) tri, (2, 2) knn.
// `split`, the lanes a query, is 1, 2, 4, 8, 16 or 32.
extern "C" int lego_odom_assoc(const float* query, const float* ref,
                               const uint8_t* ref_valid, const int32_t* ref_ring,
                               const uint8_t* query_ground,
                               const uint8_t* ref_ground, int B, int Q, int N,
                               int n_same, int n_adj, int split, int32_t* idx,
                               float* d2, cudaStream_t stream) {
  if (B < 1 || B > 65535 || Q < 1 || N < 1 ||
      (query_ground == nullptr) != (ref_ground == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_same == 0 && n_adj == 1)
    return (int)launch_split<0, 1>(query, ref, ref_valid, ref_ring, query_ground,
                                   ref_ground, B, Q, N, split, idx, d2, stream);
  if (n_same == 1 && n_adj == 1)
    return (int)launch_split<1, 1>(query, ref, ref_valid, ref_ring, query_ground,
                                   ref_ground, B, Q, N, split, idx, d2, stream);
  if (n_same == 2 && n_adj == 2)
    return (int)launch_split<2, 2>(query, ref, ref_valid, ref_ring, query_ground,
                                   ref_ground, B, Q, N, split, idx, d2, stream);
  return (int)cudaErrorInvalidValue;
}
