// E1: the degeneracy projection of a symmetric 6x6 or 3x3 matrix, on the
// device.
//
// No Pallas kernel stands behind this one: the JAX package computes
//   lego_loam_tpu/models/odometry.py :: _degeneracy_projection
//   lam, V = eigh(H);  P = V diag(lam >= thresh) V^T
// with jnp.linalg.eigh, which XLA runs without a host round trip.  In
// PyTorch, torch.linalg.eigh on a CUDA tensor reads cuSOLVER's info code
// back to the host: one host sync on every call, 5 a scan in the odometry
// and 1 a mapping solve.  This kernel takes that sync off the path, so a
// chunk of scans runs without the host waiting on the card.  The block and
// joint odometry and the mapping solve hand it 6x6 systems; the two-step
// odometry (odom_mode="two_step") solves 3 degrees of freedom a phase and
// hands it 3x3 ones, 2 phases x 5 rounds a scan.
//
// What it computes: H is symmetrised in float64 as (H + H^T) / 2 (jnp's
// eigh symmetrises its input too), diagonalised by cyclic Jacobi rotations
// in float64 registers until the off-diagonal mass is below 1e-30 of the
// Frobenius mass (at most kMaxSweeps sweeps), and then
//   lam = the diagonal, rounded to float32 and sorted ascending,
//   P   = sum over k with float(lam_k) >= thresh of v_k v_k^T, in float64,
//         rounded to float32.
// The keep test reads the float32-rounded eigenvalue, so the mask is the
// one the plain version (float32 eigh, then lam >= thresh) would take
// wherever both land on the same side of thresh.  V itself never leaves
// the kernel: the sign, order and basis of a repeated eigenvalue's vectors
// do not show in P, only the kept subspace does.  A zero matrix, or one
// with exact zeros off the diagonal (the masked block rows of the odometry
// solve), needs no rotation: a rotation runs only where a_pq != 0.
//
// What bounds it on an H100: latency.  The work is 36 numbers in, 42 out
// and a few thousand float64 operations (9 in, 12 out and a few hundred at
// 3x3), far below a microsecond of bandwidth or FP64 rate; the call is the
// one launch.  One thread does one matrix (the size is a template
// argument and every index of the unrolled loops a compile-time constant,
// so A and V stay in registers); the wrapper launches a batch of B
// matrices as ceil(B / 32) blocks of 32 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxSweeps = 32;   // 6x6 converges in ~6 sweeps (quadratic)

// One Jacobi rotation in the (p, q) plane, zeroing a[p][q]: A <- J^T A J,
// V <- V J, with t the smaller root of t^2 + 2 theta t - 1 = 0.
template <int kN, int p, int q>
__device__ __forceinline__ void rotate(double (&a)[kN][kN], double (&v)[kN][kN]) {
  const double apq = a[p][q];
  if (apq == 0.0) return;
  const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
  const double t = fabs(theta) > 1e100
                       ? 0.5 / theta
                       : copysign(1.0, theta) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = rsqrt(t * t + 1.0);
  const double s = t * c;
#pragma unroll
  for (int k = 0; k < kN; ++k) {   // columns p, q of A J
    const double akp = a[k][p], akq = a[k][q];
    a[k][p] = c * akp - s * akq;
    a[k][q] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {   // rows p, q of J^T (A J)
    const double apk = a[p][k], aqk = a[q][k];
    a[p][k] = c * apk - s * aqk;
    a[q][k] = s * apk + c * aqk;
  }
  a[p][q] = 0.0;
  a[q][p] = 0.0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {   // columns p, q of V J
    const double vkp = v[k][p], vkq = v[k][q];
    v[k][p] = c * vkp - s * vkq;
    v[k][q] = s * vkp + c * vkq;
  }
}

template <int kN, int p, int q>
__device__ __forceinline__ void sweep_from(double (&a)[kN][kN], double (&v)[kN][kN]) {
  rotate<kN, p, q>(a, v);
  if constexpr (q + 1 < kN) {
    sweep_from<kN, p, q + 1>(a, v);
  } else if constexpr (p + 2 < kN) {
    sweep_from<kN, p + 1, p + 2>(a, v);
  }
}

template <int kN>
__global__ void __launch_bounds__(kThreads)
eig_kernel(const float* __restrict__ H, float thresh, float* __restrict__ P,
            float* __restrict__ lam, int32_t* __restrict__ sweeps, int B) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* h = H + b * kN * kN;
  double a[kN][kN], v[kN][kN];
  double frob = 0.0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      a[i][j] = 0.5 * ((double)h[i * kN + j] + (double)h[j * kN + i]);
      v[i][j] = i == j ? 1.0 : 0.0;
      frob += a[i][j] * a[i][j];
    }
  }
  int s = 0;
  for (; s < kMaxSweeps; ++s) {
    double off = 0.0;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
#pragma unroll
      for (int j = i + 1; j < kN; ++j) off += a[i][j] * a[i][j];
    }
    if (off <= 1e-30 * frob) break;   // also a zero matrix (0 <= 0)
    sweep_from<kN, 0, 1>(a, v);
  }

  float d[kN];
  double keep[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    d[k] = (float)a[k][k];
    keep[k] = d[k] >= thresh ? 1.0 : 0.0;
  }
  float* out = P + b * kN * kN;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < kN; ++k) acc += keep[k] * v[i][k] * v[j][k];
      out[i * kN + j] = (float)acc;
    }
  }
  // ascending eigenvalues: an unrolled bubble sort (static indices)
#pragma unroll
  for (int i = 0; i < kN - 1; ++i) {
#pragma unroll
    for (int j = 0; j < kN - 1 - i; ++j) {
      const float lo = fminf(d[j], d[j + 1]), hi = fmaxf(d[j], d[j + 1]);
      d[j] = lo;
      d[j + 1] = hi;
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) lam[b * kN + k] = d[k];
  sweeps[b] = s;
}

}  // namespace

// H (B, n, n) float32 -> P (B, n, n) float32, lam (B, n) float32
// ascending, sweeps (B,) int32 (Jacobi sweeps taken), for n = 3 or 6.
// Returns cudaGetLastError().
extern "C" int lego_eig6(const float* H, float thresh, float* P, float* lam,
                         int32_t* sweeps, int B, int n, cudaStream_t stream) {
  if (B < 1 || (n != 3 && n != 6)) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  if (n == 6)
    eig_kernel<6><<<blocks, kThreads, 0, stream>>>(H, thresh, P, lam, sweeps, B);
  else
    eig_kernel<3><<<blocks, kThreads, 0, stream>>>(H, thresh, P, lam, sweeps, B);
  return (int)cudaGetLastError();
}
