"""The yardstick of the kernels' roofline shares: the card's published
peaks, and each kernel's operations and bytes counted from the inputs of
its launches, whatever implements it.

Bytes are each input read once and each output written once; operations
are what these inputs need.  The least time is the larger of bytes over the
memory rate and operations over the arithmetic rate (the counts of the
port's smoke run, chip_smoke.py, copied here).
"""

from __future__ import annotations

# published peaks at the full power limit (NVIDIA's H100 SXM data sheet):
# HBM3 bytes/s, float32 and float64 operations/s outside the tensor cores;
# the kernels' 32-bit integer and compare work is counted at the float32 rate
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_per_s": 67e12,
                              "fp64_per_s": 34e12},
}


def bound_s(n_bytes: float, ops: float, peaks: dict, rate: str = "fp32_per_s"):
    """The least seconds the card could take for this work."""
    return max(n_bytes / peaks["bytes_per_s"], ops / peaks[rate])


def k1_work(pixels: int):
    """K1 label propagation over `pixels` pixels: labels0 (4 B) and four
    edge masks (1 B each) read, the labels (4 B) written: 12 B a pixel,
    no arithmetic counted (bytes, ops)."""
    return 12 * pixels, 0


def k2_work(kept: int, cells: int, rings: int, pick_steps: int):
    """K2, the feature-label step, over `rings` rings of `cells` output
    cells in all, `kept` of them kept cells: rng, valid, col, ground of each
    kept cell (10 B), labels and picked of every cell (5 B), count (4 B a
    ring); the curvature stencil (13 operations a kept cell), then a
    compare and a select a kept cell for each of `pick_steps` pick steps."""
    return 10 * kept + 5 * cells + 4 * rings, kept * (13 + 2 * pick_steps)


def k3_work(batch: int, q: int, n: int, k: int, valid_refs: int):
    """K3 exact k-NN of `batch` searches of q queries among n references
    (`valid_refs` valid over the batch): queries and references (12 B a
    point), the validity (1 B a reference), indices and distances (8 B a
    neighbour); 8 operations (3 sub, 3 mul, 2 add) a query for each valid
    reference."""
    return (batch * (12 * q + 13 * n + 8 * q * k), 8 * q * valid_refs)


def e1_bytes(n: int) -> int:
    """E1 on one n x n matrix: H read, P, the eigenvalues and the sweep
    count written (316 B at 6x6, 88 B at 3x3)."""
    return 4 * (2 * n * n + n + 1)


def e1_ops(sweeps: int, n: int) -> int:
    """E1's float64 operations on one n x n matrix: the symmetrisation
    (2 n^2), `sweeps` Jacobi sweeps of n (n - 1) / 2 rotations (the angle
    about 10 operations, then two rows and two columns of A and two columns
    of V, n x (4 mul + 2 add) each) with their off-diagonal sums
    (n (n - 1)), and P (n^2 entries of n terms, 3 operations each)."""
    return (2 * n * n + sweeps * (n * (n - 1) // 2 * (10 + 18 * n) + n * (n - 1))
            + 3 * n ** 3)
