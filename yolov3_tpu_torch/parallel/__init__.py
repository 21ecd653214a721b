"""Multi-device parallelism on a single-controller mesh: batch-DP
(throughput) and spatial row + channel partitioning (latency).

Port of ``yolov3_tpu/parallel/``: one process drives every shard's device
(``sharding.Mesh``), as the reference's ``shard_map`` does; the shards'
exchanges are ``collectives``. ``dryrun.dryrun_multichip`` is the
counterpart of the reference's multi-chip dry run.
"""
from .sharding import (batch_sharding, make_mesh, replicate, shard_params,
                       sharded_pipeline)
from .spatial import (make_spatial_mesh, plan_spatial, spatial_pipeline,
                      SpatialPlan)

__all__ = ["make_mesh", "batch_sharding", "replicate", "shard_params",
           "sharded_pipeline", "make_spatial_mesh", "plan_spatial",
           "spatial_pipeline", "SpatialPlan"]
