"""Ranks of the distributed back end as threads of one process (not
collected; free of jax, so chip_smoke.py can import it as well).

run_ranks(fn, W) runs fn(comm) on W ranks, each a thread with its own
real gloo process group (dist.ProcessGroupGloo over one in-memory
HashStore): the collectives go through gloo, with no spawned process and
no second torch import.  Pin torch to one thread around it, as the tests
do, or the ranks' thread pools oversubscribe the host.

frontend_course runs the port's front end over a course once, and
sharded_course feeds its output to a ShardedBackend as LegoLoamPipeline
feeds mapping_step.
"""

from __future__ import annotations

import datetime
import itertools
import threading

import torch
import torch.distributed as dist

from lego_loam_tpu_torch.models import mapping as mp
from lego_loam_tpu_torch.models import odometry as odo
from lego_loam_tpu_torch.models.fusion import fuse_pose
from lego_loam_tpu_torch.models.pipeline import frontend_step
from lego_loam_tpu_torch.parallel.comm import Comm
from lego_loam_tpu_torch.utils.math3d import Pose

GLOO_TIMEOUT_S = 60     # a collective that waits longer fails
JOIN_TIMEOUT_S = 600    # the whole run
_runs = itertools.count()


def run_ranks(fn, world: int, join_timeout: float = JOIN_TIMEOUT_S) -> list:
    """fn(comm) on `world` thread ranks; their results in rank order.  The
    first rank's exception is raised again here; a rank still running after
    `join_timeout` seconds raises TimeoutError."""
    store = dist.PrefixStore(f"ranks{next(_runs)}", dist.HashStore())
    out, errs = [None] * world, [None] * world

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(store, r, world,
                                       datetime.timedelta(seconds=GLOO_TIMEOUT_S))
            out[r] = fn(Comm(pg))
        except BaseException as e:       # noqa: BLE001 -- re-raised below
            errs[r] = e

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(join_timeout)
    for r, e in enumerate(errs):
        if e is not None:
            raise e
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank of {world} ran past {join_timeout} s")
    return out


def frontend_course(cfg, scans, device="cpu") -> list:
    """The port's front end over a course: (mapping features, odometry
    pose) a scan, the features as mapping_step takes them (the sweep's
    reference clouds).  The front end does not depend on the back end, so
    one pass feeds any number of back ends.  scans: (xyz, valid, ring)
    tensors on the device."""
    ostate = odo.init_state(cfg, torch.device(device))
    latch = Pose.identity(device=device)
    out = []
    for xyz, valid, ring in scans:
        ostate, feats, opose, _, _, _ = frontend_step(
            ostate, xyz, valid, ring, latch, latch, None, cfg, cfg.sensor.use_ring)
        out.append(mapping_features(ostate, feats, opose))
    return out


def mapping_features(ostate, feats, opose):
    """(features, odometry pose) of a front-end step, as mapping_step takes
    them."""
    return feats._replace(less_sharp=ostate.ref_corner,
                          less_flat=ostate.ref_surf), opose


def sharded_course(backend, cfg, fronts, stamps=None, loop_every=None):
    """A ShardedBackend fed as LegoLoamPipeline feeds mapping_step: every
    cfg.mapping_process_every-th scan (from the first) of `fronts`
    (frontend_course's) goes through backend.step with
    models/mapping.scan_clouds' clouds, the outliers included, and with
    `loop_every` every loop_every-th scan then through backend.loop_step,
    as the pipeline orders them.  stamps default to frame * scan_period.
    Returns (mapped poses, one a solve; fused poses, one a scan; loop
    flags, one a check)."""
    mapped, fused, closed = [], [], []
    for k, (feats, opose) in enumerate(fronts):
        t = stamps[k] if stamps is not None else k * cfg.sensor.scan_period
        if k % cfg.mapping_process_every == 0:
            corner, surf, outlier = mp.scan_clouds(feats, cfg)
            T, _ = backend.step(*corner, *surf, opose, t, outlier=outlier)
            mapped.append(T)
        if loop_every and k % loop_every == 0:
            closed.append(bool(backend.loop_step(t).closed))
        fused.append(fuse_pose(backend.state, opose))
    return mapped, fused, closed
