// K2: the whole feature-label step of a packed scan in one launch --
// curvature, occlusion mask, suppression reach, ring median, sector picks.
//
// Replaces the Pallas TPU kernel
//   lego_loam_tpu/ops/features_pallas.py :: pick_features_pallas
// and the XLA prep that fed it in lego_loam_tpu/ops/features.py ::
// label_features (compute_curvature, occlusion_mask, _suppress_reach, the
// median prominence gate, _sector_bounds).  Plain counterpart:
// ops/features.py::label_features_plain, which is pick_features_plain (the
// pick loop, at the TPU kernel's own boundary) over pick_inputs (the prep).
// Labels and picks equal the plain version's bit for bit.
//
// What it computes, per ring r of count n = count[r] kept cells:
//  * curvature of base cells (valid, 5 <= i <= n-6): (sum of the 10
//    neighbours - 10 r)^2 over rng * valid, rounded in the plain order;
//  * picked0: occlusion (depth step > occlusion_depth_gap between columns
//    closer than occlusion_col_diff marks 6 cells on the far side) and
//    parallel beams, over 5 <= i <= n-7;
//  * the reach of each base cell: up to 5 cells a side, cut at column gaps
//    > 10 (a base cell is never cut by the ring's ends);
//  * corner threshold max(edge_threshold, edge_prominence * median), the
//    median being the ((n_ok-1)//2)-th smallest base curvature (0 if none);
//  * then n_corner corner steps (largest curvature, label 2 for the first
//    n_sharp steps, 1 after) and n_surf surf steps (smallest curvature,
//    label -1), each taking a sector's best eligible cell, ties to the
//    lowest index, and marking that cell's reach band picked (not after
//    the last surf step), in one of two orders:
//      sector_parallel: in each step every sector picks against the same
//        `picked` snapshot (all corner steps, then all surf steps);
//      sequential (the reference's order, featureAssociation.cpp:686-770):
//        sector 0's corner steps, then its surf steps, then sector 1's,
//        ..., each against the bands of every earlier step.
//    ops/features.py::pick_features_plain computes both.
// Nothing at or beyond n can be labelled or picked (each formula ends at
// n-1, and no wrap-around matters), so only [0, n) is read: 10 bytes a
// cell (rng, valid, col, ground).
//
// What bounds it on an H100: latency.  A VLP-16 scan is 16 x 1800 cells, a
// few hundred KB in all; the work is 24 dependent pick steps after a short
// prep.  The same prep in tensor ops runs 215 device kernels a scan
// (every roll, compare and the segmented median sort is one or more).
//
// What the design does about it: one block per ring (rings are
// independent), 8 warps, everything in shared memory and registers.
//  * Prep: the ring's [0, n) goes to shared memory (rng, rng * valid, col,
//    flags); each thread then takes cells i = 5 + tid, 5 + tid + 256, ...
//    and computes curvature (__fmul_rn / __fadd_rn: no contraction into
//    FMAs, so the rounding is the plain version's), the occlusion marks
//    (scattered into the shared `picked` row) and the packed reach.
//  * Median: radix select on the curvature's bits (a square: its bits order
//    as an unsigned int), 4 passes of 8 bits, each into its own 256-bin
//    shared histogram (the first filled during the prep); every warp scans
//    each histogram itself with shuffles, so a pass costs one barrier.
//  * Picks: one warp per sector (S <= 8).  Lane l holds a contiguous run of
//    the sector's cells, CPL = 4, 6, 8, 10, 12 or 16 of them (the least
//    that holds ceil((W - 10) / 6) / 32: 10 at W = 1800), as 32-bit keys in
//    registers: curvature bits + 1 for a corner cell, ~bits for a surf
//    cell, 0 for none, so a larger key is a better pick and 0 is "no
//    pick".  A step: the lane's best key (a max tree), the warp's with
//    __reduce_max_sync, the lowest lane holding it by __ballot_sync /
//    __ffs and its lowest cell (runs ascend with the lane, so that is the
//    lowest index); that lane writes the label and publishes its band
//    (lo, hi) to a double-buffered shared slot.  ONE __syncthreads a step;
//    after it every warp reads the bands that can reach its cells (its own
//    sector's and its neighbours', since from n = 40 on every sector spans
//    at least 5 cells; all of them on a shorter ring), clears its cells
//    inside them in a register bitmask, and marks its own band in the
//    shared `picked` row, which becomes the output.
//  * The sequential order (the JAX package runs it as a loop of 144
//    dependent XLA steps; it has no Pallas kernel): sector j's picks must
//    see every band of sectors < j, and a band reaches into the next
//    sector.  So the sectors take turns: S block barriers a scan, one
//    before each sector.  After its barrier, warp j rebuilds its register
//    bitmask from the shared `picked` row (which holds every earlier band,
//    however far it reached: no short-ring case is needed) and runs its 24
//    steps warp-locally -- the holder of the pick broadcasts its band with
//    a shuffle, every lane clears its cells inside it, and the band's lanes
//    mark it in the shared row for the later sectors.  Only one warp a
//    block works at a time; the blocks (rings) still run side by side.
//  * Output: labels (int32) and picked (bytes) of the whole row, zero at
//    and beyond n.
// Measured on an H100 (PERF.md): ~60 % of the cycles are the 24
// pick steps (~650 cycles each), ~20 % the median, the rest load, prep and
// output.

#include <cuda_runtime.h>
#include <stdint.h>

// The cfg scalars (mirrored by ops/features.py::_Params).
struct LegoFeatureParams {
  float edge_threshold;
  float edge_prominence;
  float surf_threshold;
  float occlusion_depth_gap;
  float parallel_beam_frac;
  int occlusion_col_diff;
  int n_sectors;
  int n_corner;     // corner steps (edge_feature_num_less)
  int n_sharp;      // of which labelled 2 (edge_feature_num)
  int n_surf;
  int sector_parallel;   // 0: the reference's sector-by-sector order
  int use_median;   // edge_prominence > 0
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSectors = 8;     // one warp each; the block's warps
constexpr int kThreads = 32 * kMaxSectors;
constexpr int kNoBand = 0xffff;    // lo = 65535 > hi = 0
constexpr int kMaxCpl = 16;        // cells a lane holds, at most
// base cells a thread takes in the median's passes, at most (W <= 3082)
constexpr int kMaxCellsPerThread = (6 * 32 * kMaxCpl + kThreads - 1) / kThreads;
constexpr uint8_t kValid = 1, kGround = 2, kBase = 4;

// The largest of a[0 .. N), as a tree (constant offsets, so the array
// stays in registers).
template <int N>
__device__ __forceinline__ uint32_t tree_max(const uint32_t* a) {
  if constexpr (N == 1) {
    return a[0];
  } else {
    return max(tree_max<N / 2>(a), tree_max<N - N / 2>(a + N / 2));
  }
}

// Bit j set where a[j] == x, as a tree.
template <int N>
__device__ __forceinline__ uint32_t eq_mask(const uint32_t* a, uint32_t x) {
  if constexpr (N == 1) {
    return a[0] == x ? 1u : 0u;
  } else {
    return eq_mask<N / 2>(a, x) |
           (eq_mask<N - N / 2>(a + N / 2, x) << (N / 2));
  }
}

// Marks a lane's cells [c0, c0 + nl) inside band (lo | hi << 16) picked.
__device__ __forceinline__ void clear_band(uint32_t& pk, int band, int c0,
                                           int nl) {
  const int a = max((band & 0xffff) - c0, 0);
  const int z = min((band >> 16) - c0, nl - 1);
  if (a <= z) pk |= ((2u << (z - a)) - 1u) << a;
}

// A lane's pick keys for one pass: curvature bits + 1 for a corner cell
// (non-ground base cell above thr), ~bits for a surf cell (ground base
// cell below surf_thr), 0 for none; a larger key is a better pick.
template <int CPL>
__device__ __forceinline__ void load_keys(uint32_t (&key)[CPL], bool surf,
                                          int c0, int nl, const float* s_curv,
                                          const uint8_t* s_flag, float thr,
                                          float surf_thr) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    key[j] = 0;
    if (j < nl) {
      const float cv = s_curv[c0 + j];
      const uint8_t f = s_flag[c0 + j] & (kBase | kGround);
      if (!surf && f == kBase && cv > thr) key[j] = __float_as_uint(cv) + 1u;
      if (surf && f == (kBase | kGround) && cv < surf_thr)
        key[j] = ~__float_as_uint(cv);
    }
  }
}

// One pick step of a warp over its sector: the best key among the
// unpicked cells (ties to the lowest cell: runs ascend with the lane), its
// label written.  Returns the lane holding the pick (-1 if the sector has
// none); that lane's `band` is the pick's band (lo | hi << 16), or kNoBand
// if !mark; every other lane's is kNoBand.
template <int CPL>
__device__ __forceinline__ int pick_step(const uint32_t (&key)[CPL],
                                         uint32_t pk, int c0,
                                         uint64_t reach_lo, uint64_t reach_hi,
                                         int lane, int label, bool mark,
                                         int8_t* s_lab, int& band) {
  uint32_t v[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) v[j] = (pk >> j) & 1u ? 0u : key[j];
  const uint32_t best = __reduce_max_sync(kFull, tree_max<CPL>(v));
  band = kNoBand;
  if (best == 0) return -1;
  const uint32_t eq = eq_mask<CPL>(v, best);
  const int holder = __ffs(__ballot_sync(kFull, eq != 0)) - 1;
  if (lane == holder) {
    const int jj = __ffs(eq) - 1;
    const int cell = c0 + jj;
    const int code =
        (int)(((jj < 8 ? reach_lo : reach_hi) >> (8 * (jj & 7))) & 0xff);
    s_lab[cell] = (int8_t)label;
    if (mark) band = (cell - (code & 15)) | ((cell + (code >> 4)) << 16);
  }
  return holder;
}

__device__ __forceinline__ int floor_div6(int a) {
  const int q = a / 6;
  return (a % 6 != 0 && a < 0) ? q - 1 : q;
}

// One radix-select pass, by every lane of a warp: the bin of the k-th
// smallest (0-based) count of a 256-bin histogram is appended to `prefix`
// and k becomes its rank inside that bin.  Needs 0 <= k < the total.
__device__ __forceinline__ void select_bin(const int* hist, int lane, int& k,
                                           unsigned& prefix) {
  const int4 a = reinterpret_cast<const int4*>(hist)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
  const int h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int local = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) local += h[i];
  int inc = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  int before = inc - local;
  const int holder =
      __ffs(__ballot_sync(kFull, before <= k && k < inc)) - 1;
  int bin = 0;
  bool found = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    found = found || k < before + h[i];
    if (!found) {
      before += h[i];
      bin = i + 1;
    }
  }
  bin = __shfl_sync(kFull, 8 * lane + bin, holder);
  k -= __shfl_sync(kFull, before, holder);
  prefix = (prefix << 8) | (unsigned)bin;
}

// The number of base cells (the sum of a 256-bin histogram), in every lane.
__device__ __forceinline__ int hist_total(const int* hist, int lane) {
  const int4 a = reinterpret_cast<const int4*>(hist)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
  int t = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  return t;
}

template <int CPL>
__global__ void label_features_kernel(const float* __restrict__ rng,
                                      const uint8_t* __restrict__ valid,
                                      const int32_t* __restrict__ col,
                                      const uint8_t* __restrict__ ground,
                                      const int32_t* __restrict__ count,
                                      int32_t* __restrict__ labels_out,
                                      uint8_t* __restrict__ picked_out, int W,
                                      LegoFeatureParams p) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* s_rng = reinterpret_cast<float*>(sm);
  float* s_rv = s_rng + W;                  // rng * valid
  float* s_curv = s_rv + W;
  int32_t* s_col = reinterpret_cast<int32_t*>(s_curv + W);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_col + W);
  uint8_t* s_reach = s_flag + W;            // reach_l | reach_r << 4
  uint8_t* s_pick = s_reach + W;
  int8_t* s_lab = reinterpret_cast<int8_t*>(s_pick + W);
  __shared__ __align__(16) int s_hist[4][256];   // one a radix pass
  __shared__ __align__(16) int s_slot[2][kMaxSectors];

  const int tid = threadIdx.x, nt = kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row = (size_t)blockIdx.x * W;
  const int n = min(max(count[blockIdx.x], 0), W);

  if (n < 12) {  // no sector and no occlusion test: nothing to label
    for (int c = tid; c < W; c += nt) {
      labels_out[row + c] = 0;
      picked_out[row + c] = 0;
    }
    return;
  }

  // ---- load [0, n) ---------------------------------------------------------
  for (int c = tid; c < n; c += nt) {
    const float x = rng[row + c];
    const bool v = valid[row + c] != 0;
    s_rng[c] = x;
    s_rv[c] = __fmul_rn(x, v ? 1.0f : 0.0f);
    s_col[c] = col[row + c];
    s_flag[c] = (v ? kValid : 0) | (ground[row + c] ? kGround : 0);
    s_pick[c] = 0;
    s_lab[c] = 0;
  }
  for (int i = tid; i < 4 * 256; i += nt) (&s_hist[0][0])[i] = 0;
  __syncthreads();

  // ---- prep: curvature, reach, occlusion marks; the median's first digit ---
  for (int c = 5 + tid; c <= n - 6; c += nt) {
    const uint8_t f = s_flag[c];
    if (f & kValid) {
      float acc = __fmul_rn(-10.0f, s_rv[c]);
#pragma unroll
      for (int off = 1; off <= 5; ++off)
        acc = __fadd_rn(__fadd_rn(acc, s_rv[c - off]), s_rv[c + off]);
      const float cv = __fmul_rn(acc, acc);
      s_curv[c] = cv;
      s_flag[c] = f | kBase;
      if (p.use_median) atomicAdd(&s_hist[0][__float_as_uint(cv) >> 24], 1);
      // 5 <= c <= n-6: the ring's ends never cut the reach, column gaps do
      int rl = 0, rr = 0;
      bool okl = true, okr = true;
#pragma unroll
      for (int l = 1; l <= 5; ++l) {
        okr = okr && abs(s_col[c + l] - s_col[c + l - 1]) <= 10;
        okl = okl && abs(s_col[c - l + 1] - s_col[c - l]) <= 10;
        rr += okr;
        rl += okl;
      }
      s_reach[c] = (uint8_t)(rl | (rr << 4));
    }
    if (c <= n - 7) {
      const float x = s_rng[c], nx = s_rng[c + 1];
      if (abs(s_col[c + 1] - s_col[c]) < p.occlusion_col_diff) {
        if (__fsub_rn(x, nx) > p.occlusion_depth_gap) {
#pragma unroll
          for (int o = 0; o <= 5; ++o) s_pick[c - o] = 1;
        }
        if (__fsub_rn(nx, x) > p.occlusion_depth_gap) {
#pragma unroll
          for (int o = 1; o <= 6; ++o) s_pick[c + o] = 1;
        }
      }
      const float t = __fmul_rn(p.parallel_beam_frac, x);
      if (fabsf(__fsub_rn(s_rng[c - 1], x)) > t && fabsf(__fsub_rn(nx, x)) > t)
        s_pick[c] = 1;
    }
  }
  __syncthreads();

  // ---- the ring median of base curvature: radix select, 4 x 8 bits --------
  // Every warp scans each histogram itself, so a pass costs one barrier.
  float thr = p.edge_threshold;
  if (p.use_median) {
    unsigned prefix = 0;               // 0 bits = 0.0f without a base cell
    int k = (hist_total(s_hist[0], lane) - 1) >> 1;
    if (k >= 0) {
      select_bin(s_hist[0], lane, k, prefix);
      for (int pass = 1; pass < 4; ++pass) {
        const int shift = 24 - 8 * pass;
#pragma unroll
        for (int i = 0; i < kMaxCellsPerThread; ++i) {
          const int c = 5 + tid + i * kThreads;
          if (c > n - 6 || !(s_flag[c] & kBase)) continue;
          const unsigned u = __float_as_uint(s_curv[c]);
          if ((u >> (shift + 8)) == prefix)
            atomicAdd(&s_hist[pass][(u >> shift) & 255], 1);
        }
        __syncthreads();
        select_bin(s_hist[pass], lane, k, prefix);
      }
    }
    float med = __uint_as_float(prefix);
    if (!isfinite(med)) med = 0.0f;
    thr = fmaxf(p.edge_threshold, __fmul_rn(p.edge_prominence, med));
  }

  // ---- picks: one warp a sector, a contiguous run of cells a lane ----------
  const int S = p.n_sectors;
  // a band reaches 5 cells past its pick; every sector spans at least
  // (n - 10) / 6 cells, so from n = 40 on a band touches only the sectors
  // beside its own
  const bool near_only = (n - 10) / 6 >= 5;
  int c0 = 0, nl = 0;
  if (warp < S) {
    const int e = n - 6;
    const int sp = floor_div6(4 * (6 - warp) + e * warp);
    const int ep = floor_div6(4 * (5 - warp) + e * (warp + 1)) - 1;
    if (sp < ep) {
      // only base cells (5 <= i <= n-6) are ever eligible
      const int lo = max(sp, 5), len = min(ep, n - 6) - lo + 1;
      if (len > 0) {
        const int q = (len + 31) >> 5;   // <= CPL: checked by the host
        c0 = lo + lane * q;
        nl = min(max(len - lane * q, 0), q);
      }
    }
  }
  uint32_t key[CPL];
  uint64_t reach_lo = 0, reach_hi = 0;   // 8 bits a cell
  uint32_t pk = 0;                       // this lane's picked cells
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (j < nl) {
      const int c = c0 + j;
      if (s_pick[c]) pk |= 1u << j;
      const uint64_t code = s_reach[c];
      if (j < 8) reach_lo |= code << (8 * j);
      else reach_hi |= code << (8 * (j & 7));
    }
  }
  load_keys<CPL>(key, false, c0, nl, s_curv, s_flag, thr, p.surf_threshold);

  const int T = p.n_corner + p.n_surf;
  if (p.sector_parallel) {
    int buf = 0;
    for (int t = 0; t < T; ++t) {
      const bool surf = t >= p.n_corner;
      // the surf pass: ground cells, the smallest curvature first
      if (t == p.n_corner)
        load_keys<CPL>(key, true, c0, nl, s_curv, s_flag, thr, p.surf_threshold);
      int band;
      // the last surf step marks no band
      const int holder = pick_step<CPL>(
          key, pk, c0, reach_lo, reach_hi, lane,
          surf ? -1 : (t < p.n_sharp ? 2 : 1), !(surf && t == T - 1), s_lab,
          band);
      if (lane == max(holder, 0)) s_slot[buf][warp] = band;
      __syncthreads();
      {
        // the step's bands (warps without a sector publish none): those of
        // this sector and its neighbours, or all of them on a short ring
        const int own = s_slot[buf][warp];
        if (near_only) {
          clear_band(pk, own, c0, nl);
          clear_band(pk, s_slot[buf][max(warp - 1, 0)], c0, nl);
          clear_band(pk, s_slot[buf][min(warp + 1, kMaxSectors - 1)], c0, nl);
        } else {
          const int4 b0 = reinterpret_cast<const int4*>(s_slot[buf])[0];
          const int4 b1 = reinterpret_cast<const int4*>(s_slot[buf])[1];
          const int bands[kMaxSectors] = {b0.x, b0.y, b0.z, b0.w,
                                          b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int s = 0; s < kMaxSectors; ++s) clear_band(pk, bands[s], c0, nl);
        }
        if (lane <= (own >> 16) - (own & 0xffff)) s_pick[(own & 0xffff) + lane] = 1;
      }
      buf ^= 1;
    }
  } else {
    // the reference's order: the sectors take turns, one barrier each
    for (int s = 0; s < S; ++s) {
      __syncthreads();   // every band of sectors < s is in s_pick
      if (warp != s) continue;
      pk = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (j < nl && s_pick[c0 + j]) pk |= 1u << j;
      for (int t = 0; t < T; ++t) {
        const bool surf = t >= p.n_corner;
        if (t == p.n_corner)
          load_keys<CPL>(key, true, c0, nl, s_curv, s_flag, thr, p.surf_threshold);
        int band;
        const int holder = pick_step<CPL>(
            key, pk, c0, reach_lo, reach_hi, lane,
            surf ? -1 : (t < p.n_sharp ? 2 : 1), !(surf && t == T - 1), s_lab,
            band);
        if (holder >= 0) band = __shfl_sync(kFull, band, holder);
        clear_band(pk, band, c0, nl);
        if (lane <= (band >> 16) - (band & 0xffff))
          s_pick[(band & 0xffff) + lane] = 1;
      }
    }
  }
  __syncthreads();

  for (int c = tid; c < W; c += nt) {
    labels_out[row + c] = c < n ? (int32_t)s_lab[c] : 0;
    picked_out[row + c] = c < n ? s_pick[c] : 0;
  }
}

template <int CPL>
int launch(const float* rng, const uint8_t* valid, const int32_t* col,
           const uint8_t* ground, const int32_t* count, int32_t* labels,
           uint8_t* picked, int R, int W, const LegoFeatureParams& p,
           cudaStream_t stream) {
  const size_t smem = (size_t)W * 20;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        label_features_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  label_features_kernel<CPL><<<R, kThreads, smem, stream>>>(
      rng, valid, col, ground, count, labels, picked, W, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Cells a lane holds at ring width W: a sector spans at most
// ceil((W - 10) / 6) cells whatever its index (ops/features.py::
// _cells_per_lane says the same).
static int cells_per_lane(int W) {
  const int len = W > 10 ? (W - 10 + 5) / 6 : 0;
  return (len + 31) / 32;
}

extern "C" int lego_label_features(const float* rng, const uint8_t* valid,
                                   const int32_t* col, const uint8_t* ground,
                                   const int32_t* count, int32_t* labels,
                                   uint8_t* picked, int R, int W,
                                   const LegoFeatureParams* params,
                                   cudaStream_t stream) {
  const LegoFeatureParams p = *params;
  if (p.n_sectors < 1 || p.n_sectors > kMaxSectors || R < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int q = cells_per_lane(W);
#define LEGO_K2_LAUNCH(CPL)                                                  \
  if (q <= CPL)                                                              \
    return launch<CPL>(rng, valid, col, ground, count, labels, picked, R, W, \
                       p, stream);
  LEGO_K2_LAUNCH(4)
  LEGO_K2_LAUNCH(6)
  LEGO_K2_LAUNCH(8)
  LEGO_K2_LAUNCH(10)
  LEGO_K2_LAUNCH(12)
  LEGO_K2_LAUNCH(kMaxCpl)
#undef LEGO_K2_LAUNCH
  return (int)cudaErrorInvalidValue;
}
