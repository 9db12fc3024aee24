"""E1 (lego::eig6, csrc/eig6.cu): percent of its roofline, the work
counted from its launches (the bytes of each matrix, the float64
operations of the Jacobi sweeps each took) over the device time of the
kernels under the op's innermost events in the traced layer chunk."""

from slam_bench.roofline import bound_s, e1_bytes, e1_ops

CAPTURE = ("lego_loam_tpu_torch.ops.eig6", "eig6")


def keep(args, out):
    H = args[0]
    return H.shape[-1], out[2]


def read(t):
    if t.peaks is None:
        return None
    b = 0.0
    for n, sweeps in t.kept["e1_roofline_pct"]:
        m = sweeps.numel()
        ops = m * e1_ops(0, n) + int(sweeps.sum()) * (e1_ops(1, n) - e1_ops(0, n))
        b += bound_s(m * e1_bytes(n), ops, t.peaks, "fp64_per_s")
    return t.op_share("lego::eig6", b)
