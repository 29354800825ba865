"""File IO, checkpoints and the host escape hatch (port of
``spartan_tpu/expr/fio.py``).

* :class:`HostExpr`: a NumPy function over the evaluated inputs, run on the
  host, for ops whose output shape depends on the data (a boolean part
  inside a tuple index; ``where`` with one argument).  Its abstract value
  raises :class:`NotShapeable`, so the evaluator evaluates it before the
  region that reads it.
* :func:`save` / :func:`load`: the reference's on-disk format, one ``.npy``
  file a shard (``shard_00000.npy`` …) and a ``manifest.json`` (shape,
  dtype, mesh shape, partition spec, each shard's extent) written last, by
  an atomic rename, so a crash mid-save leaves no manifest.  Each package
  reads the other's files: a dense array of the port is one shard over the
  whole array (its spec is empty), and :func:`load` assembles any number of
  shards on the host before one upload.  bfloat16, which NumPy lacks, is
  written as float32.
* :class:`CheckpointExpr` / :func:`checkpoint`: the child's result is
  saved on its first evaluation and restored from disk instead of
  recomputed when the manifest exists; the evaluator takes the node before
  the region around it (``_eager_boundary``).
* :func:`from_file`: a ``.npy`` file or a saved directory as a leaf.

The reference's multi-process save (each process writing the shards it
holds) waits for the multi-process form of the mesh.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from spartan_tpu_torch.core.array import SpartanArray, from_numpy
from spartan_tpu_torch.core.extent import TileExtent
from spartan_tpu_torch.expr.base import Expr, NotShapeable, Val, lazify
from spartan_tpu_torch.util import log_info, log_warn

counts = {"host_runs": 0}


class HostExpr(Expr):
  """``fn(*inputs)`` on the host, over NumPy copies of the inputs."""

  _members = ("inputs",)
  _params = ("fn",)

  def __init__(self, inputs, fn: Callable):
    super().__init__(inputs=[lazify(v) for v in inputs], fn=fn)

  def aval(self):
    raise NotShapeable(f"host op {self.fn} has a data-dependent shape")

  def _emit(self, ctx, deps):
    raise NotShapeable("host op must be evaluated eagerly")

  def evaluate_eager(self) -> SpartanArray:
    counts["host_runs"] += 1
    args = [c.evaluate().glom() for c in self.inputs]
    return from_numpy(np.asarray(self.fn(*args)))


class CheckpointExpr(Expr):
  """Persist the child's result on its first evaluation; later evaluations
  (and fresh processes) restore it from ``path`` instead of recomputing
  its lineage."""

  _members = ("inputs",)
  _params = ("path",)
  _eager_boundary = True

  def __init__(self, child, path: str):
    super().__init__(inputs=[lazify(child)], path=path)

  def aval(self):
    return self.inputs[0].aval()

  def _emit(self, ctx, deps):
    return deps[0]

  def evaluate_eager(self) -> SpartanArray:
    if os.path.exists(os.path.join(self.path, "manifest.json")):
      log_info("checkpoint restore: %s", self.path)
      restored = load(self.path)
      want = tuple(self.inputs[0].shape)
      if tuple(restored.shape) != want:
        log_warn("checkpoint %s restored shape %s but the expression "
                 "produces %s: a stale checkpoint? (the path names the "
                 "artifact; delete it to recompute)", self.path,
                 tuple(restored.shape), want)
      return restored
    result = self.inputs[0].evaluate()
    save(result, self.path)
    return result

  def evaluate(self) -> SpartanArray:
    if self._cache is None:
      self._cache = self.evaluate_eager()
    return self._cache


def checkpoint(v, path: str) -> CheckpointExpr:
  return CheckpointExpr(v, path)


def _host_copy(data: torch.Tensor) -> np.ndarray:
  t = data.detach()
  if t.dtype == torch.bfloat16:
    t = t.float()
  return t.cpu().numpy()


def save(v, path: str) -> None:
  """Write an array (or expr) as one ``.npy`` file a shard plus the
  manifest, the manifest last."""
  arr = v.evaluate() if isinstance(v, Expr) else v
  os.makedirs(path, exist_ok=True)
  extents = arr.tiling.extents(arr.shape)
  host = _host_copy(arr.data)
  manifest = {
      "shape": list(arr.shape),
      "dtype": host.dtype.name,
      "mesh_shape": {k: int(s) for k, s in arr.tiling.mesh.shape.items()},
      "spec": list(arr.tiling.spec),
      "num_shards": len(extents),
      "shards": [{"ul": list(e.ul), "lr": list(e.lr)} for e in extents],
  }
  for i, ext in enumerate(extents):
    # temp + rename: a shard file either is whole or is not there
    tmp = os.path.join(path, f".shard_{i:05d}.{os.getpid()}.tmp.npy")
    np.save(tmp, host[ext.to_slice()])
    os.replace(tmp, os.path.join(path, f"shard_{i:05d}.npy"))
  # the manifest last: its presence means every shard is on disk
  tmp = os.path.join(path, f".manifest.{os.getpid()}.tmp")
  with open(tmp, "w") as f:
    json.dump(manifest, f)
  os.replace(tmp, os.path.join(path, "manifest.json"))


def load(path: str, mesh=None) -> SpartanArray:
  """Read an array that :func:`save` of either package wrote, its shards
  assembled on the host, onto ``mesh``'s device (default: the active
  mesh's)."""
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)
  shape = tuple(manifest["shape"])
  out = np.empty(shape, dtype=np.dtype(manifest["dtype"]))
  for i, sh in enumerate(manifest["shards"]):
    ext = TileExtent(sh["ul"], sh["lr"], shape)
    out[ext.to_slice()] = np.load(os.path.join(path, f"shard_{i:05d}.npy"))
  return from_numpy(out, mesh=mesh)


def from_file(path: str, tile_hint=None) -> Expr:
  """A leaf read from a ``.npy`` file or a directory :func:`save` wrote."""
  if os.path.isdir(path):
    return Val(load(path))
  return Val(from_numpy(np.load(path), tile_hint))
