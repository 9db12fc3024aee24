"""K2 (lego::label_features, csrc/pick_features.cu): percent of its
roofline, the work counted from its launches' inputs (the kept cells of
each ring, every output cell) over the device time of the kernels under the
op's innermost events in the traced layer chunk."""

from slam_bench.roofline import bound_s, k2_work

CAPTURE = ("lego_loam_tpu_torch.ops.features", "_launch_label_features")


def keep(args, out):
    rng, count = args[0], args[4]
    return count, rng.numel(), rng.shape[-1]


def read(t):
    if t.peaks is None:
        return None
    steps = t.cfg.edge_feature_num_less + t.cfg.surf_feature_num
    b = 0.0
    for count, cells, width in t.kept["k2_roofline_pct"]:
        kept = int(count.clamp(0, width).sum())
        b += bound_s(*k2_work(kept, cells, count.numel(), steps), t.peaks)
    return t.op_share("lego::label_features", b)
