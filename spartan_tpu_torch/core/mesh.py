"""The device mesh of the port: p logical shards of one ``torch.device``.

Port of ``spartan_tpu/core/mesh.py``.  The reference places arrays on a
``jax.sharding.Mesh`` over a TPU slice (or over virtual CPU devices).  The
port's mesh keeps the reference's vocabulary (``axis_names``, ``shape``,
``size``, ``devices``) over one explicit ``torch.device``: each of its
``size`` positions is a logical shard of that one device.  A sharded kernel
route gives each shard its own row band and its own launches (the
reference's ``shard_map`` body, once per device), all on the same card.
The default mesh is one shard; ``--mesh_shape=2x4`` or
``make_mesh(shape=...)`` asks for more.  A mesh over several cards is later
work.

The device is never guessed: it comes from the caller or from
``FLAGS.device`` (default ``"cuda"``), and :func:`make_mesh` raises when it
is absent instead of carrying on elsewhere.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from spartan_tpu_torch.config import FLAGS

_state = threading.local()


def _best_2d_factors(n: int) -> Tuple[int, int]:
  """Near-square factorization of ``n`` (1×n for primes)."""
  best = (1, n)
  f = 1
  while f * f <= n:
    if n % f == 0:
      best = (f, n // f)
    f += 1
  return best


class Mesh:
  """``size`` logical shards of one device, laid out as ``shape``."""

  __slots__ = ("device", "axis_names", "_sizes")

  def __init__(self, device: Union[str, torch.device],
               shape: Sequence[int] = (1,),
               axis_names: Optional[Sequence[str]] = None):
    sizes = tuple(int(s) for s in shape)
    if not sizes or any(s < 1 for s in sizes):
      raise ValueError(f"a mesh shape needs positive sizes, got {shape!r}")
    names = (tuple(axis_names) if axis_names is not None
             else ("x", "y", "z", "w")[:len(sizes)])
    if len(names) != len(sizes) or len(set(names)) != len(names):
      raise ValueError(f"axis names {names!r} do not name the mesh shape "
                       f"{sizes!r} one to one")
    self.device = torch.device(device)
    self.axis_names = names
    self._sizes = sizes

  @property
  def shape(self) -> Dict[str, int]:
    """Axis name → number of shards along it (the reference's
    ``mesh.shape``)."""
    return dict(zip(self.axis_names, self._sizes))

  @property
  def size(self) -> int:
    n = 1
    for s in self._sizes:
      n *= s
    return n

  @property
  def devices(self) -> Tuple[torch.device, ...]:
    """One entry a shard, in row-major order of the shape: all the same
    device."""
    return (self.device,) * self.size

  def __eq__(self, other):
    return (isinstance(other, Mesh) and other.device == self.device
            and other._sizes == self._sizes
            and other.axis_names == self.axis_names)

  def __hash__(self):
    return hash((self.device, self._sizes, self.axis_names))

  def __repr__(self):
    return f"Mesh({self.device}, {self.shape})"


def _shape_from(shape) -> Tuple[int, ...]:
  if shape is None:
    if FLAGS.mesh_shape:
      return tuple(int(s) for s in FLAGS.mesh_shape.lower().split("x"))
    return (1,)
  if isinstance(shape, int):
    return _best_2d_factors(shape)
  return tuple(int(s) for s in shape)


def make_mesh(device: Union[str, torch.device, None] = None,
              shape: Union[int, Sequence[int], None] = None,
              axis_names: Optional[Sequence[str]] = None) -> Mesh:
  """A mesh over ``device`` (default ``FLAGS.device``); raises when the
  device does not exist on this host.  ``shape`` is a tuple of shard
  counts, or a count that is factored near-square into two axes; without
  it, ``FLAGS.mesh_shape`` (e.g. ``"2x4"``), else one shard."""
  dev = torch.device(device if device is not None else FLAGS.device)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          f"device {dev} requested but torch.cuda.is_available() is False; "
          "pass --device=cpu to run on the CPU")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
      raise RuntimeError(f"device {dev} requested but only "
                         f"{torch.cuda.device_count()} CUDA devices exist")
    dev = torch.device("cuda", index)
  elif dev.type != "cpu":
    raise ValueError(f"unsupported mesh device {dev} (expected cuda or cpu)")
  return Mesh(dev, _shape_from(shape), axis_names)


_default_mesh: Optional[Mesh] = None


def get_mesh() -> Mesh:
  """The active mesh: the innermost ``with_mesh`` context, else the process
  default (built from ``FLAGS.device`` on first use)."""
  stack = getattr(_state, "stack", None)
  if stack:
    return stack[-1]
  global _default_mesh
  if _default_mesh is None:
    _default_mesh = make_mesh()
  return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
  global _default_mesh
  _default_mesh = mesh


@contextlib.contextmanager
def with_mesh(mesh: Mesh):
  if not hasattr(_state, "stack"):
    _state.stack = []
  _state.stack.append(mesh)
  try:
    yield mesh
  finally:
    _state.stack.pop()


def replicated(mesh: Optional[Mesh] = None):
  """The replicated placement on ``mesh`` (default: the active one): a
  tiling with the empty spec, every shard reading the whole array (the
  reference's ``NamedSharding(mesh, PartitionSpec())``)."""
  from spartan_tpu_torch.core.tiling import Tiling
  return Tiling(mesh or get_mesh())


def num_devices(mesh: Optional[Mesh] = None) -> int:
  """The number of shards of ``mesh`` (default: the active one)."""
  return (mesh or get_mesh()).size
