"""Blocked Cholesky factorization of an SPD matrix (port of
``spartan_tpu/examples/cholesky.py``).

The reference's right-looking algorithm: for each block column, factor the
small diagonal block, solve the panel against it, and update the trailing
matrix.  The O(n²b) panel solve and rank-b update are ``sp.dot`` and
``sp.assign`` over the expression layer, as in the reference; the b × b
diagonal factor and its triangular inverse, which the reference computes
with NumPy on the host, are ``torch.linalg`` calls on the device
(``cholesky_ex``: a failed block is read once, after the last).
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp


def factor(A, block: int = 128):
  """Lower-triangular L with ``L @ L.T == A`` for SPD A (numpy, expr or
  SpartanArray); one block column a step.  Raises
  ``numpy.linalg.LinAlgError`` when a diagonal block is not positive
  definite, as the reference's host factor does.  Returns a
  SpartanArray."""
  A = sp.lazify(A)
  n = A.shape[0]
  work = sp.Val(A.evaluate())
  out = sp.Val(sp.zeros((n, n), dtype=np.float64).evaluate())
  failed = []
  for j0 in range(0, n, block):
    j1 = min(j0 + block, n)
    ajj = work[j0:j1, j0:j1].evaluate().data.to(torch.float64)
    ljj, info = torch.linalg.cholesky_ex(ajj)
    failed.append(info)
    linv_t = torch.linalg.solve_triangular(
        ljj, torch.eye(j1 - j0, dtype=ljj.dtype, device=ljj.device),
        upper=False).mT
    out = sp.assign(out, (slice(j0, j1), slice(j0, j1)), sp.Val(ljj))
    if j1 < n:
      panel = sp.Val(sp.dot(work[j1:, j0:j1], sp.Val(linv_t),
                            precision="highest").evaluate())
      out = sp.assign(out, (slice(j1, n), slice(j0, j1)), panel)
      trail = work[j1:, j1:] - sp.dot(panel, panel.T, precision="highest")
      work = sp.Val(sp.assign(work, (slice(j1, n), slice(j1, n)),
                              trail).evaluate())
    out = sp.Val(out.evaluate())
  if bool(torch.stack(failed).any()):
    raise np.linalg.LinAlgError("Matrix is not positive definite")
  return out.evaluate()


def run(n: int = 512, block: int = 128, seed: int = 0):
  rng = np.random.default_rng(seed)
  m = rng.standard_normal((n, n))
  A = m @ m.T + n * np.eye(n)
  L = factor(A, block=block)
  err = float(np.abs(np.asarray(L.glom()) - np.linalg.cholesky(A)).max())
  return L, err
