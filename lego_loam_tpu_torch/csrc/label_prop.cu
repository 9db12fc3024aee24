// K1: connected-component labelling of the range image.
//
// Replaces the Pallas TPU kernel
//   lego_loam_tpu/ops/segmentation_pallas.py :: propagate_labels_pallas
// (whose plain counterpart is the XLA loop in lego_loam_tpu/ops/
// segmentation.py::label_components).  Every segmentable pixel starts at its
// linear index; the result is, for each pixel, the minimum linear index of
// its 4-connected component (columns wrap around).  That fixpoint is unique,
// so any scheme that reaches it gives identical labels.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The problem is
// 16 x 1800 int32 labels (115 KB) plus four connectivity masks, a few dozen
// dependent passes over it, and nothing else.  Any round trip through device
// memory between passes (the XLA loop launches ~30 ops per sweep) costs more
// than the work itself.
//
// What the design does about it: ONE thread block keeps the whole label grid
// in dynamic shared memory (115 KB of the 227 KB a block may opt into) and
// the four masks packed to bits (4 x 3.6 KB, built with warp ballots), and
// runs every sweep inside the block.  A doubled row array for the
// wraparound, as the TPU kernel uses, would not fit (230 KB alone): columns
// wrap by modular indexing instead.  Each sweep is label-equivalence
// union-find rather than segmented scans: a hook phase lowers each pixel and
// the pixel its label points at to the minimum over its connected
// neighbours (shared-memory atomicMin), then a pointer-jumping phase sends
// every label to the end of its chain.  Labels only ever name pixels of the
// same component and only decrease, so the loop stops at the unique min-index
// fixpoint; a sweep with no change anywhere ends it.  The kernel writes its
// sweep count.  Grids that do not fit in one block's shared memory
// (VLS-128 at 128 x 1800) are refused by the host entry.
//
// Precondition (as built by label_components): labels0[p] is p for a
// segmentable pixel and >= R*H otherwise, and the masks only connect
// segmentable pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool bit(const uint32_t* m, int i) {
  return (m[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
label_prop_kernel(const int32_t* __restrict__ labels0,
                  const uint8_t* __restrict__ conn_left,
                  const uint8_t* __restrict__ conn_right,
                  const uint8_t* __restrict__ conn_up,
                  const uint8_t* __restrict__ conn_down,
                  int32_t* __restrict__ out, int32_t* __restrict__ sweeps_out,
                  int R, int H, int max_sweeps) {
  extern __shared__ uint32_t smem[];
  const int n = R * H;
  const int nw = (n + 31) >> 5;
  int* lab = reinterpret_cast<int*>(smem);
  volatile int* vlab = lab;
  uint32_t* m_l = smem + n;
  uint32_t* m_r = m_l + nw;
  uint32_t* m_u = m_r + nw;
  uint32_t* m_d = m_u + nw;
  const int tid = threadIdx.x;

  for (int i = tid; i < n; i += kThreads) lab[i] = labels0[i];
  // pack the masks: each warp reads 32 consecutive bytes per mask and
  // ballots them into one word (the loop bound is uniform per warp)
  for (int i = tid; i < nw * 32; i += kThreads) {
    const bool in = i < n;
    const uint32_t bl = __ballot_sync(0xffffffffu, in && conn_left[i]);
    const uint32_t br = __ballot_sync(0xffffffffu, in && conn_right[i]);
    const uint32_t bu = __ballot_sync(0xffffffffu, in && conn_up[i]);
    const uint32_t bd = __ballot_sync(0xffffffffu, in && conn_down[i]);
    if ((tid & 31) == 0) {
      m_l[i >> 5] = bl;
      m_r[i >> 5] = br;
      m_u[i >> 5] = bu;
      m_d[i >> 5] = bd;
    }
  }
  __syncthreads();

  int it = 0;
  bool changed = true;
  while (changed && it < max_sweeps) {
    bool local = false;
    // hook: min over connected neighbours, applied to the pixel and to the
    // pixel its current label names (both lie in the same component)
    for (int p = tid; p < n; p += kThreads) {
      const int l = vlab[p];
      if (l >= n) continue;
      const int r = p / H;
      const int c = p - r * H;
      int m = l;
      if (bit(m_l, p)) m = min(m, vlab[r * H + (c == 0 ? H - 1 : c - 1)]);
      if (bit(m_r, p)) m = min(m, vlab[r * H + (c == H - 1 ? 0 : c + 1)]);
      if (r > 0 && bit(m_u, p)) m = min(m, vlab[p - H]);
      if (r < R - 1 && bit(m_d, p)) m = min(m, vlab[p + H]);
      if (m < l) {
        atomicMin(&lab[l], m);
        atomicMin(&lab[p], m);
        local = true;
      }
    }
    __syncthreads();
    // pointer jumping: lab[x] <= x for every labelled pixel, so chains end
    for (int p = tid; p < n; p += kThreads) {
      int l = vlab[p];
      if (l >= n) continue;
      int ll = vlab[l];
      if (ll < l) {
        do {
          l = ll;
          ll = vlab[l];
        } while (ll < l);
        atomicMin(&lab[p], l);
        local = true;
      }
    }
    changed = __syncthreads_or(local);
    ++it;
  }

  for (int i = tid; i < n; i += kThreads) out[i] = lab[i];
  if (tid == 0) *sweeps_out = it;
}

}  // namespace

extern "C" size_t lego_label_prop_smem_bytes(int R, int H) {
  const size_t n = (size_t)R * H;
  return n * 4 + 4 * ((n + 31) / 32) * 4;
}

extern "C" int lego_label_prop(const int32_t* labels0, const uint8_t* conn_left,
                               const uint8_t* conn_right, const uint8_t* conn_up,
                               const uint8_t* conn_down, int32_t* out,
                               int32_t* sweeps, int R, int H, int max_sweeps,
                               cudaStream_t stream) {
  const size_t smem = lego_label_prop_smem_bytes(R, H);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(label_prop_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  label_prop_kernel<<<1, kThreads, smem, stream>>>(
      labels0, conn_left, conn_right, conn_up, conn_down, out, sweeps, R, H,
      max_sweeps);
  return (int)cudaGetLastError();
}
