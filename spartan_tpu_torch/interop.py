"""Carry state across from the reference package.

The reference's arrays reach the port as numpy — what ``spartan_tpu``'s
``SpartanArray.glom()`` returns — and come out as the port's
``SpartanArray``s on a given device with the exact dtype (float64 stays
float64, int64 stays int64, bool stays bool).  Objects with a ``glom()``
method (the reference's arrays and exprs) are gathered first, and the
reference's sparse matrices (``cols``/``vals``/``shape``/``nnz`` for the
padded ELL, ``block_cols``/``block_vals``/``shape``/``bs``/``nnz_blocks``
for block-ELL) are rebuilt from their buffers, all by duck typing, so this
module never imports jax.  Tests use it to give both packages the same data,
the same matrices and the same initial weights, and
:func:`from_reference_padded` carries a padded stencil state across.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from spartan_tpu_torch.backend.kernels.stencil import PAD_C, PAD_R
from spartan_tpu_torch.backend.sparse import (BlockSparseArray, SparseArray,
                                              _upload)
from spartan_tpu_torch.core.array import from_numpy
from spartan_tpu_torch.core.mesh import get_mesh, make_mesh


def from_reference(value: Any,
                   device: Union[str, torch.device, None] = None) -> Any:
  """Port ``value`` (an ndarray, a reference array/expr or sparse matrix,
  or a list, tuple or dict of them) onto ``device`` (default: the active
  mesh's)."""
  mesh = make_mesh(device) if device is not None else get_mesh()
  if isinstance(value, dict):
    return {k: from_reference(v, mesh.device) for k, v in value.items()}
  if isinstance(value, (list, tuple)):
    return type(value)(from_reference(v, mesh.device) for v in value)
  if hasattr(value, "block_cols"):
    return BlockSparseArray(_upload(value.block_cols, mesh.device),
                            _upload(value.block_vals, mesh.device),
                            value.shape, value.bs, value.nnz_blocks)
  if hasattr(value, "cols") and hasattr(value, "nnz"):
    out = SparseArray(_upload(value.cols, mesh.device),
                      _upload(value.vals, mesh.device), value.shape,
                      value.nnz)
    out.fmt = getattr(value, "fmt", "csr")
    return out
  glom = getattr(value, "glom", None)
  host = np.asarray(glom() if callable(glom) else value)
  return from_numpy(host, mesh=mesh)


def from_reference_padded(xp_ref: Any,
                          device: Union[str, torch.device, None] = None
                          ) -> torch.Tensor:
  """Port a reference padded-storage state (``stencil_pallas.to_padded``'s
  layout, which the port keeps: interior at ``[PAD_R:-PAD_R,
  PAD_C:-PAD_C]``) as the tensor that ``stencil3x3_padded`` takes; raises
  unless it is 2-D with a non-empty interior and a zero pad ring."""
  xp = from_reference(xp_ref, device).data
  if xp.dim() != 2 or xp.shape[0] <= 2 * PAD_R or xp.shape[1] <= 2 * PAD_C:
    raise ValueError(f"a padded state is (n + {2 * PAD_R}, m + {2 * PAD_C}) "
                     f"with n, m >= 1, got shape {tuple(xp.shape)}")
  ring = torch.ones(xp.shape, dtype=torch.bool, device=xp.device)
  ring[PAD_R:-PAD_R, PAD_C:-PAD_C] = False
  if bool((xp[ring] != 0).any()):
    raise ValueError("the padded state's ring is not zero")
  return xp
