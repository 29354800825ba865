"""Tall-skinny QR by CholeskyQR2 (port of ``spartan_tpu/examples/qr.py``).

Each round forms the d × d Gram matrix ``XᵀX`` (one contraction), factors
it on the device (the reference factors it with NumPy on the host) and
forms ``Q = X R⁻¹``; a second round squares away the first's loss of
orthogonality (‖QᵀQ − I‖ ~ ε instead of ε·κ(X)²).
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp


def _chol_qr_once(X):
  """One CholeskyQR round: (Q as a leaf, R upper-triangular on the
  device)."""
  g = sp.dot(X.T, X, precision="highest").evaluate().data
  r = torch.linalg.cholesky_ex(g)[0].mT
  r_inv = torch.linalg.solve_triangular(
      r, torch.eye(r.shape[0], dtype=r.dtype, device=r.device), upper=True)
  q = sp.dot(X, sp.Val(r_inv), precision="highest")
  return sp.Val(q.evaluate()), r


def tsqr(X):
  """Q (n × d SpartanArray, orthonormal columns) and R (d × d numpy,
  upper-triangular) with ``Q @ R == X``."""
  X = sp.lazify(X)
  q1, r1 = _chol_qr_once(X)
  q, r2 = _chol_qr_once(q1)
  return q, (r2 @ r1).cpu().numpy()


def run(n: int = 1 << 14, d: int = 32, seed: int = 0):
  rng = np.random.default_rng(seed)
  xn = rng.standard_normal((n, d))
  q, r = tsqr(sp.from_numpy(xn))
  qn = np.asarray(q.glom())
  orth_err = float(np.abs(qn.T @ qn - np.eye(d)).max())
  recon_err = float(np.abs(qn @ r - xn).max())
  return orth_err, recon_err
