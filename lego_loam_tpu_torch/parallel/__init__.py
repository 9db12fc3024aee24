"""The distributed back end (counterpart of ``lego_loam_tpu.parallel``) on
torch.distributed: one process a rank (one a card, NCCL between cards;
gloo on the CPU), each holding its shard and calling the collectives of
:class:`comm.Comm` where the JAX package calls psum / all_gather inside
shard_map.

  * graph.py: the edge-sharded pose graph;
  * map_sharded.py: the map-sharded k-NN (kernel K3 on each shard);
  * backend_sharded.py: the sharded mapping solve, loop check and the
    ShardedBackend host loop.
"""
