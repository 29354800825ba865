"""Poisson's equation ``∇²u = f`` with a zero (Dirichlet) boundary by
weighted-Jacobi sweeps, port of the Jacobi part of
``spartan_tpu/examples/poisson.py``.  The spectral solver (``solve``,
``laplacian``, ``run``) needs ``sp.fft`` and ``sp.roll`` and comes with
them.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import stencil as K


def solve_jacobi(f, iters: int = 200, h: float = 1.0, unroll: int = 8):
  """``iters`` sweeps ``u' = (u_N + u_S + u_E + u_W)/4 - h²f/4`` from
  ``u = 0`` over padded float32 storage on the mesh's device, each one pass
  of kernel K6a with the constant field as its add operand.  ``unroll``
  sweeps go to each call of the kernel wrapper.  ``f`` is an (n, m) array
  (numpy or a tensor); returns ``u`` as numpy float32."""
  fj = torch.as_tensor(f if isinstance(f, torch.Tensor) else np.asarray(f),
                       dtype=torch.float32, device=sp.get_mesh().device)
  coeffs = (0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0)
  g = K.to_padded(-(h * h / 4.0) * fj)
  xp = torch.zeros_like(g)
  buf = torch.zeros_like(g)
  done = 0
  while done < iters:
    k = min(unroll, iters - done)
    xp, buf = K.stencil3x3_padded(xp, buf, coeffs, steps=k, add=g)
    done += k
  return K.from_padded(xp).cpu().numpy()


def solve_jacobi_numpy(f, iters: int = 200, h: float = 1.0):
  f = np.asarray(f, np.float64)
  u = np.zeros_like(f)
  for _ in range(iters):
    up = np.pad(u, 1)
    u = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
         ) / 4.0 - (h * h / 4.0) * f
  return u
