"""Tiling metadata (port of ``spartan_tpu/core/tiling.py``).

In the reference a :class:`Tiling` pairs a mesh with a ``PartitionSpec``
and derives the logical tile grid from the sharding.  The port keeps dense
arrays whole on the mesh's device, replicated across its logical shards:
a tiling is the mesh plus an empty spec, and its one extent covers the
whole array.  The sharded sparse and stencil routes cut their own row
bands (``backend/sparse.py``, ``backend/kernels/stencil.py``).  The
reference's ``choose_spec`` and per-tile extents come with per-shard
storage of dense arrays, which reads them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from spartan_tpu_torch.core.extent import TileExtent, from_shape
from spartan_tpu_torch.core.mesh import Mesh, get_mesh


class Tiling:
  """A mesh plus a partition spec: the placement of one array."""

  __slots__ = ("mesh", "spec")

  def __init__(self, mesh: Mesh):
    self.mesh = mesh
    self.spec = ()  # replicated: every shard reads the whole tensor

  def extents(self, array_shape: Sequence[int]) -> List[TileExtent]:
    """Logical tile rectangles: one, covering the array."""
    return [from_shape(array_shape)]

  def __eq__(self, other):
    return isinstance(other, Tiling) and self.mesh == other.mesh

  def __hash__(self):
    return hash(self.mesh)

  def __repr__(self):
    return f"Tiling(mesh={self.mesh.shape}, spec={self.spec})"


def auto_tiling(shape: Sequence[int],
                tile_hint: Optional[Sequence[int]] = None,
                mesh: Optional[Mesh] = None) -> Tiling:
  """Default tiling for a freshly created array (``shape`` and
  ``tile_hint`` kept for the reference's signature)."""
  del shape, tile_hint
  return Tiling(mesh or get_mesh())
