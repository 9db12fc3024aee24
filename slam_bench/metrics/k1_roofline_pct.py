"""K1 (lego::label_prop, csrc/label_prop.cu): percent of its roofline,
the least time for the work counted from its launches' inputs (12 B a
pixel) over the device time of the kernels under the op's innermost
events in the traced layer chunk."""

from slam_bench.roofline import bound_s, k1_work

CAPTURE = ("lego_loam_tpu_torch.ops.segmentation", "_launch_label_prop")


def keep(args, out):
    return args[0].numel()


def read(t):
    if t.peaks is None:
        return None
    b = sum(bound_s(*k1_work(px), t.peaks) for px in t.kept["k1_roofline_pct"])
    return t.op_share("lego::label_prop", b)
