"""K3 (lego::knn, csrc/knn.cu): percent of its roofline, the work counted
from its launches' inputs (8 operations a query for each valid reference;
each input read and each output written once) over the device time of the
kernels under the op's innermost events in the traced layer chunk."""

from slam_bench.roofline import bound_s, k3_work

CAPTURE = ("lego_loam_tpu_torch.ops.knn", "_launch_knn")


def keep(args, out):
    query, ref, ref_valid, k = args[:4]
    return query.numel() // (3 * query.shape[-2]), query.shape[-2], ref.shape[-2], k, ref_valid


def read(t):
    if t.peaks is None:
        return None
    b = sum(bound_s(*k3_work(B, q, n, k, int(valid.sum())), t.peaks)
            for B, q, n, k, valid in t.kept["k3_roofline_pct"])
    return t.op_share("lego::knn", b)
