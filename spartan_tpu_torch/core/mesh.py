"""The device "mesh" of the port: one ``torch.device``.

Port of ``spartan_tpu/core/mesh.py``.  The reference places arrays on a
``jax.sharding.Mesh`` over a TPU slice; this first slice of the port runs
on a single device, so a mesh holds exactly one explicit ``torch.device``
and every array and every region of the DAG lives there.  Multi-device
meshes (``torch.distributed`` DeviceMesh) are later work.

The device is never guessed: it comes from the caller or from
``FLAGS.device`` (default ``"cuda"``), and :func:`make_mesh` raises when it
is absent instead of carrying on elsewhere.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple, Union

import torch

from spartan_tpu_torch.config import FLAGS

_state = threading.local()


class Mesh:
  """A mesh of one device."""

  __slots__ = ("device",)

  def __init__(self, device: torch.device):
    self.device = torch.device(device)

  @property
  def devices(self) -> Tuple[torch.device, ...]:
    return (self.device,)

  @property
  def size(self) -> int:
    return 1

  def __eq__(self, other):
    return isinstance(other, Mesh) and other.device == self.device

  def __hash__(self):
    return hash(self.device)

  def __repr__(self):
    return f"Mesh({self.device})"


def make_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
  """A mesh over ``device`` (default ``FLAGS.device``); raises when the
  device does not exist on this host."""
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
  return Mesh(dev)


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

