"""Core substrate: extent algebra, the mesh of logical shards of one device,
tiling metadata, arrays."""

from spartan_tpu_torch.core.array import SpartanArray, from_numpy
from spartan_tpu_torch.core.extent import TileExtent
from spartan_tpu_torch.core.mesh import (Mesh, get_mesh, make_mesh,
                                         num_devices, set_default_mesh,
                                         with_mesh)
from spartan_tpu_torch.core.tiling import Tiling

__all__ = ["SpartanArray", "from_numpy", "TileExtent", "Mesh", "get_mesh",
           "make_mesh", "num_devices", "set_default_mesh", "with_mesh",
           "Tiling"]
