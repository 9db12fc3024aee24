// K1: connected-component labelling of the range image, across the card.
//
// Replaces the Pallas TPU kernel
//   lego_loam_tpu/ops/segmentation_pallas.py :: propagate_labels_pallas
// (whose plain counterpart is the XLA loop in lego_loam_tpu/ops/
// segmentation.py::label_components).  Every segmentable pixel starts at its
// linear index; the result is, for each pixel, the minimum linear index of
// its 4-connected component (columns wrap around: (r, H-1) neighbours
// (r, 0)).  That fixpoint is unique, so any scheme that reaches it gives
// identical labels: this one is union-find, where the TPU ran segmented
// scans.
//
// What bounds it on an H100: latency, not bytes or operations.  The bytes
// are 12 a pixel (labels in, four byte masks in, labels out): 0.10 us on a
// VLP-16 image (16 x 1800) at 3.35 TB/s, 0.83 us on VLS-128 (128 x 1800),
// both below the cost of one launch.  What is left to win is the distance
// to a launch-level floor: the work has to spread over many SMs, in one
// launch, with few dependent steps.
//
// What the design does about it: ONE cooperative launch
// (cudaLaunchCooperativeKernel) of one block a tile, the blocks all
// co-resident, three phases split by two grid-wide barriers
// (cooperative_groups::this_grid().sync()).
//  * Tiles of kTileRows x kTileCols = 8 x 64 pixels, 256 threads a block,
//    2 pixels a thread, each warp on 32 consecutive pixels of a row; the
//    last column of tiles is ragged (1800 and 1024 are not multiples of
//    64).  Grids: VLP-16 2 x 29 = 58 blocks, OS1-16 2 x 16 = 32, HDL-32E
//    4 x 29 = 116, OS1-64 8 x 16 = 128, HDL-64E 8 x 29 = 232, VLS-128
//    16 x 29 = 464.  A block takes 2 KB of shared memory, so several fit an
//    SM and every preset is co-resident on 132 SMs; the wrapper checks that
//    against cudaOccupancyMaxActiveBlocksPerMultiprocessor before the
//    launch, and a cooperative launch that does not fit is refused by the
//    runtime as well.  A batch of B scans (models/batch.py) is one launch
//    of B times a scan's blocks, block i on tile i % tiles of scan
//    i / tiles; the barriers then span the batch, so the wrapper
//    (ops/segmentation.py) splits a batch into the fewest launches whose
//    blocks are co-resident (VLP-16 at B = 8 is 464 blocks, one launch;
//    HDL-64E at B = 8 is 1856, more than one).  Taller tiles (16 x 64, 16 x 128) spent longer in
//    phase A than they saved in phase B on real scans; 4-row tiles the
//    reverse.
//  * Loads first: each thread issues every load it needs (labels, the
//    masks of its pixels and of its border pair) before any of them is
//    used, so the phase waits for memory once.
//  * Phase A, shared memory, per tile.  Runs along a row come from warp
//    ballots of "joined to the left neighbour": each pixel's parent is the
//    start of its run (found with __clz), so a run is a star without any
//    atomic.  Then the vertical edges join runs by union-find: the larger
//    root is linked under the smaller (atomicMin, retried when another
//    thread moved that root first), and a vertical edge is skipped where
//    its left neighbour's vertical edge already joins the same two runs.
//    Finds halve the path as they go (a plain store of the grandparent:
//    always an ancestor, so a store that races with a link only loses a
//    shortcut).  Local indices run row-major like the global ones, so a
//    tile-local root is the minimum global index of its piece; each pixel
//    writes that root's global index to `out`, which serves as the global
//    parent array (a non-segmentable pixel writes its labels0).
//  * Phase B, global memory: the edges that leave a tile (its last column,
//    with the wrap from H-1 to 0, and its last row) join the two pieces'
//    roots by the same rule.  A border pair that joins the same two pieces
//    as the pair before it on the border is skipped (a warp shuffle).
//  * Phase C: each tile-local root follows its chain to the root; then
//    every other pixel copies its local root's answer.
// Why the result is exact: a parent only ever moves to a smaller index of
// the same component (atomicMin of a root, halving to an ancestor), so once
// every edge is joined a component has one root, and since its minimum
// index can have no smaller parent, that root is the minimum.
//
// max_sweeps: the XLA loop and the TPU kernel stop after a budget of full
// row-and-column sweeps (64 by default), which cuts a component whose
// minimum needs more sweeps to travel; on a scan the loop converges in a
// handful of sweeps (4 on each VLP-16 check scan, PERF.md), so the budget
// never binds there.  This kernel has no sweeps and always reaches the
// fixpoint; the wrapper keeps max_sweeps for its callers and the plain
// version.
//
// Precondition (as built by ops/segmentation.py::label_inputs): labels0[p]
// is p for a segmentable pixel and >= R*H otherwise, conn_right[p] equals
// conn_left of p's right neighbour and conn_down[p] equals conn_up of the
// pixel below (the kernel joins a pair if either side says so), and the
// masks only connect segmentable pixels (a pair with a non-segmentable end
// is not joined).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 64;
constexpr int kTilePx = kTileRows * kTileCols;
constexpr int kThreads = 256;
constexpr int kPerThread = kTilePx / kThreads;
constexpr int kRowStep = kThreads / kTileCols;   // rows between a thread's pixels
constexpr int kNone = -1;               // shared parent of a pixel outside any set
static_assert(kTilePx % kThreads == 0 && kThreads % kTileCols == 0,
              "whole pixels a thread, whole rows a step");
static_assert(kTileCols % 32 == 0, "a warp on 32 pixels of one row");
static_assert(kTileRows + kTileCols <= kThreads, "one border pair a thread");

// Root of x, halving the path: each pixel passed is pointed at its
// grandparent.  Parents never exceed their index, so the walk ends.
__device__ __forceinline__ int find(volatile int* par, int x) {
  while (true) {
    const int p = par[x];
    if (p == x) return x;
    const int gp = par[p];
    if (gp == p) return p;
    par[x] = gp;
    x = gp;
  }
}

// Root of x in a forest that no thread writes any more.
__device__ __forceinline__ int find_static(const int* par, int x) {
  for (int p = par[x]; p != x; p = par[x]) x = p;
  return x;
}

// Join the sets of a and b: the larger root is linked under the smaller one
// by atomicMin; if that root had been linked elsewhere meanwhile, atomicMin
// returns its new parent and the join is retried from there.
__device__ __forceinline__ void unite(int* par, int a, int b) {
  while (true) {
    a = find(par, a);
    b = find(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kThreads)
label_prop_kernel(const int32_t* __restrict__ labels0,
                  const uint8_t* __restrict__ conn_left,
                  const uint8_t* __restrict__ conn_right,
                  const uint8_t* __restrict__ conn_up,
                  const uint8_t* __restrict__ conn_down,
                  int32_t* out, int R, int H, int tiles_x, int tiles) {
  __shared__ int s_par[kTilePx];
  __shared__ uint32_t s_left[kTilePx / 32];   // bit: joined to the left pixel
  const int n = R * H;
  // scan blockIdx.x / tiles of the batch: every index below is local to it
  const size_t scan = (size_t)(blockIdx.x / tiles) * n;
  labels0 += scan;
  conn_left += scan;
  conn_right += scan;
  conn_up += scan;
  conn_down += scan;
  out += scan;
  const int tile = blockIdx.x % tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tile / tiles_x) * kTileRows;
  const int c0 = (tile % tiles_x) * kTileCols;
  const int th = min(kTileRows, R - r0);
  const int tw = min(kTileCols, H - c0);
  // this thread's pixels: column lc of the tile, rows lr0, lr0 + kRowStep
  const int lc = tid % kTileCols;
  const int lr0 = tid / kTileCols;

  // ---- loads, all issued before any is used -------------------------------
  int lab0[kPerThread];
  bool left[kPerThread], down[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int lr = lr0 + k * kRowStep;
    const int g = (r0 + lr) * H + c0 + lc;
    const bool in = lr < th && lc < tw;
    lab0[k] = in ? labels0[g] : n;
    left[k] = in && lc > 0 && (conn_left[g] | conn_right[g - 1]);
    down[k] = in && lr + 1 < th && (conn_down[g] | conn_up[g + H]);
  }
  // this thread's border pair for phase B: threads [0, th) the tile's last
  // column, to the right (wrapping); threads [kTileRows, kTileRows + tw)
  // its last row, downwards
  int bg = -1, bq = -1;
  if (tid < th) {
    const int r = r0 + tid;
    const int c = c0 + tw - 1;
    bg = r * H + c;
    bq = r * H + (c + 1 == H ? 0 : c + 1);
  } else if (tid >= kTileRows && tid - kTileRows < tw && r0 + th < R) {
    bg = (r0 + th - 1) * H + c0 + tid - kTileRows;
    bq = bg + H;
  }
  bool bedge = false;
  if (bg >= 0) {
    const bool joined = tid < kTileRows ? (conn_right[bg] | conn_left[bq])
                                        : (conn_down[bg] | conn_up[bq]);
    bedge = joined && labels0[bg] < n && labels0[bq] < n;
  }

  // ---- phase A: union-find inside the tile, in shared memory -------------
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int li = (lr0 + k * kRowStep) * kTileCols + lc;
    s_par[li] = lab0[k] < n ? li : kNone;
  }
  __syncthreads();
  // runs: the parent of a pixel is the start of its run within the warp's
  // 32 pixels, or the last pixel of the previous 32 when the run goes on
  // from there (a run is a star, or two stars chained)
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int li = (lr0 + k * kRowStep) * kTileCols + lc;
    const bool seg = lab0[k] < n;
    left[k] = seg && left[k] && s_par[li - 1] != kNone;
    down[k] = seg && down[k] && s_par[li + kTileCols] != kNone;
    const uint32_t m = __ballot_sync(0xffffffffu, left[k]);
    if (lane == 0) s_left[li >> 5] = m;
    const uint32_t starts = ~m & (0xffffffffu >> (31 - lane));
    if (seg) s_par[li] = starts ? li - lane + (31 - __clz(starts)) : li - lane - 1;
  }
  __syncthreads();
  // vertical edges join runs; one whose left neighbour also goes down, with
  // both rows joined there, joins nothing new
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int li = (lr0 + k * kRowStep) * kTileCols + lc;
    const uint32_t md = __ballot_sync(0xffffffffu, down[k]);
    if (!down[k]) continue;
    if (lane > 0 && ((md >> (lane - 1)) & 1u) && ((s_left[li >> 5] >> lane) & 1u) &&
        ((s_left[(li + kTileCols) >> 5] >> lane) & 1u))
      continue;
    unite(s_par, li, li + kTileCols);
  }
  __syncthreads();
  int lroot[kPerThread];                  // global index of the local root
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int lr = lr0 + k * kRowStep;
    const int g = (r0 + lr) * H + c0 + lc;
    lroot[k] = -1;
    if (lr >= th || lc >= tw) continue;
    if (lab0[k] >= n) {
      out[g] = lab0[k];
      continue;
    }
    const int root = find_static(s_par, lr * kTileCols + lc);
    lroot[k] = (r0 + root / kTileCols) * H + c0 + root % kTileCols;
    out[g] = lroot[k];
  }
  int broot = -1;                         // the border pixel's local root
  if (bedge) {
    const int root = find_static(s_par, (bg / H - r0) * kTileCols + bg % H - c0);
    broot = (r0 + root / kTileCols) * H + c0 + root % kTileCols;
  }

  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // ---- phase B: the edges that leave the tile, in global memory ----------
  volatile int32_t* vout = out;
  const int qroot = bedge ? vout[bq] : -1;
  {
    // a pair that joins the same two pieces as the pair before it on the
    // same border adds nothing
    const int pb = __shfl_up_sync(0xffffffffu, broot, 1);
    const int pq = __shfl_up_sync(0xffffffffu, qroot, 1);
    if (lane > 0 && tid != kTileRows && pb == broot && pq == qroot) bedge = false;
  }
  if (bedge) unite(out, broot, qroot);

  grid.sync();

  // ---- phase C: local roots find their root, the rest copy it ------------
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int g = (r0 + lr0 + k * kRowStep) * H + c0 + lc;
    if (lroot[k] != g) continue;
    int x = g;
    for (int p = vout[x]; p != x; p = vout[x]) x = p;
    if (x != g) out[g] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int g = (r0 + lr0 + k * kRowStep) * H + c0 + lc;
    if (lroot[k] >= 0 && lroot[k] != g) out[g] = vout[lroot[k]];
  }
}

}  // namespace

// Blocks of one launch at an R x H grid.
extern "C" int lego_label_prop_grid(int R, int H) {
  return ((R + kTileRows - 1) / kTileRows) * ((H + kTileCols - 1) / kTileCols);
}

// Blocks of this kernel that the current device holds at once (the most a
// cooperative launch may have); 0 if the device cannot launch cooperatively,
// minus the CUDA error on a failed query.
extern "C" int lego_label_prop_max_blocks() {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, label_prop_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  return coop ? per_sm * sms : 0;
}

// B scans of R x H, stored one after another, in one cooperative launch of
// B x lego_label_prop_grid(R, H) blocks (the caller keeps that within
// lego_label_prop_max_blocks()).
extern "C" int lego_label_prop(const int32_t* labels0, const uint8_t* conn_left,
                               const uint8_t* conn_right, const uint8_t* conn_up,
                               const uint8_t* conn_down, int32_t* out, int R,
                               int H, int B, cudaStream_t stream) {
  if (R < 1 || H < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int tiles_x = (H + kTileCols - 1) / kTileCols;
  int tiles = lego_label_prop_grid(R, H);
  void* args[] = {(void*)&labels0, (void*)&conn_left, (void*)&conn_right,
                  (void*)&conn_up, (void*)&conn_down, (void*)&out,
                  (void*)&R, (void*)&H, (void*)&tiles_x, (void*)&tiles};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)label_prop_kernel, dim3(B * tiles), dim3(kThreads), args, 0,
      stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
