"""Tiling metadata (port of ``spartan_tpu/core/tiling.py``).

In the reference a :class:`Tiling` pairs a mesh with a ``PartitionSpec``
and derives the logical tile grid from the sharding.  On the port's
single-device mesh every array is one tile: a tiling is the mesh plus an
empty spec, and its one extent covers the whole array.
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
    self.spec = ()  # unsharded: the port's meshes hold one device

  def extents(self, array_shape: Sequence[int]) -> List[TileExtent]:
    """Logical tile rectangles: one, covering the array."""
    return [from_shape(array_shape)]

  def __eq__(self, other):
    return isinstance(other, Tiling) and self.mesh == other.mesh

  def __hash__(self):
    return hash(self.mesh)

  def __repr__(self):
    return f"Tiling(mesh={self.mesh}, spec={self.spec})"


def auto_tiling(shape: Sequence[int],
                tile_hint: Optional[Sequence[int]] = None,
                mesh: Optional[Mesh] = None) -> Tiling:
  """Default tiling for a freshly created array (``shape`` and
  ``tile_hint`` kept for the reference's signature)."""
  del shape, tile_hint
  return Tiling(mesh or get_mesh())
