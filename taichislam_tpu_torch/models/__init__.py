"""Map types with the reference public API."""

from taichislam_tpu_torch.models.base_map import BaseMap
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
from taichislam_tpu_torch.models.dense_esdf import DenseESDF
from taichislam_tpu_torch.models.octomap import Octomap
from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
from taichislam_tpu_torch.models.topo_graph import TopoGraphGen

__all__ = ["BaseMap", "DenseTSDF", "DenseESDF", "Octomap", "SubmapMapping",
           "MarchingCubeMesher", "TopoGraphGen"]
