"""The collectives of the distributed back end: the counterpart of
``jax.lax.psum`` / ``all_gather`` / ``axis_index`` inside the JAX package's
shard_map, over one torch.distributed process group.

A world of one rank calls no collective (and so adds no host sync and no
launch) unless built with ``always=True``, which runs every collective
through the group anyway -- how a one-card run exercises NCCL.  On a CUDA
tensor NCCL orders its collectives on the stream: the host never waits for
them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """Rank, size and the two collectives of one process group: the default
    group when none is passed and torch.distributed is initialised, else a
    world of one.  `calls` counts the collectives issued."""

    def __init__(self, group=None, always: bool = False):
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.rank = 0 if group is None else group.rank()
        self.size = 1 if group is None else group.size()
        self.always = always
        self.calls = 0

    @classmethod
    def solo(cls) -> "Comm":
        """A world of one, whether or not torch.distributed is initialised."""
        comm = cls.__new__(cls)
        comm.group, comm.rank, comm.size, comm.always, comm.calls = None, 0, 1, False, 0
        return comm

    @property
    def active(self) -> bool:
        """Whether the collectives go through the group."""
        return self.group is not None and (self.size > 1 or self.always)

    def all_reduce_sum(self, *ts: torch.Tensor) -> tuple:
        """Each tensor summed over the ranks, by one all-reduce of them
        packed flat (so they must share a dtype).  Returns a tuple; the
        inputs are not changed."""
        if not self.active:
            return ts
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=self.group)
        self.calls += 1
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return tuple(out)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, ...) stack of every rank's `t` (same shape on each), in
        rank order."""
        if not self.active:
            return t[None]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        self.calls += 1
        return torch.stack(out)
