"""Spatial sharding of the generator over W and data-parallel training, one
process per rank, alone or as a 2-D mesh (counterpart of
``biasgan_tpu/parallel``): process groups and the mesh's rows and columns,
the contexts' shared collectives and the spawn runner (``mesh``), the halo
context and ``spatial_apply`` (``spatial``), the data context
(``data_parallel``), and the rank programs that hold the sharded and the
data-parallel paths to what they must equal (``checks``)."""

from biasgan_tpu_torch.parallel.data_parallel import DataCtx
from biasgan_tpu_torch.parallel.mesh import placement, spawn
from biasgan_tpu_torch.parallel.spatial import HaloCtx, pad_to_multiple, spatial_apply

__all__ = ["DataCtx", "HaloCtx", "pad_to_multiple", "placement", "spatial_apply", "spawn"]
