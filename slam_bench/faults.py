"""Lower precisions and planted faults, as hooks of harness.run_cell: the
readings that set the limits of `correct` (readings.py) and the CPU tests
that see `correct` come out false use these same hooks.  None of them runs
in the benchmark's own runs.

* tf32: the program's TF32-off policy switched back on once the pipeline
  is built (every float32 matmul and convolution in TF32);
* bf16: the control, the reference's front end computed in bfloat16 put
  in the program's place for the per-scan counts;
* frozen: a step that returns its state unchanged;
* half: half of the batch left out, its sequences fed the other half's
  scans;
* alter: an answer altered where it is produced, the first fused pose of
  every chunk moved 0.5 m.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_bench import reference as ref


def tf32_on(_bp) -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def bf16_counts(xyz, valid, ring, sensor, pcfg):
    return ref.frontend_counts(xyz, valid, ring, sensor, pcfg, q=ref.bf16)


def frozen(step):
    """The per-step function of models/batch with its new states dropped."""
    def same_state(o, m, *a, **kw):
        return (o, m, step(o, m, *a, **kw)[2])
    return same_state


def freeze_state(_bp) -> None:
    from lego_loam_tpu_torch.models import batch

    batch.scan_step = frozen(batch.scan_step)


def half_batch(xyz, valid, ring):
    h = xyz.shape[0] // 2
    return (torch.cat([xyz[:h], xyz[:h]]), torch.cat([valid[:h], valid[:h]]),
            ring)


def alter_answer(res):
    t = res.fused_poses.t.clone()
    t[:, 0] += 0.5
    return dataclasses.replace(res, fused_poses=res.fused_poses._replace(t=t))


HOOKS = {"none": {}, "tf32": {"pipeline": tf32_on},
         "bf16": {"counts": bf16_counts}, "frozen": {"pipeline": freeze_state},
         "half": {"inputs": half_batch}, "alter": {"result": alter_answer}}
