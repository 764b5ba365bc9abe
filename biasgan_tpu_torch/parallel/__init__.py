"""Spatial sharding of the generator over W, one process per shard
(counterpart of ``biasgan_tpu/parallel``): process groups and the spawn
runner (``mesh``), the halo context and ``spatial_apply`` (``spatial``),
and the rank programs that hold the sharded path to the whole field
(``checks``)."""

from biasgan_tpu_torch.parallel.mesh import placement, spawn
from biasgan_tpu_torch.parallel.spatial import HaloCtx, pad_to_multiple, spatial_apply

__all__ = ["HaloCtx", "pad_to_multiple", "placement", "spatial_apply", "spawn"]
