"""Poisson's equation ``∇²u = f`` two ways (port of
``spartan_tpu/examples/poisson.py``):

* :func:`solve`: on a periodic grid by FFT, ``u = F⁻¹[F[f] / λ(k)]`` with
  λ the 5-point Laplacian's eigenvalues, lazy through ``sp.fft`` (cuFFT on
  the card); :func:`laplacian` applies the periodic 5-point stencil by
  rolls, so its residual checks the solve;
* :func:`solve_jacobi`: with a zero (Dirichlet) boundary by weighted-Jacobi
  sweeps, each one pass of kernel K6a.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import stencil as K
from spartan_tpu_torch.core.array import SpartanArray


def _inv_laplacian_symbol(n: int, h: float, device) -> torch.Tensor:
  """The inverse eigenvalues of the 5-point Laplacian on an n × n periodic
  grid, in float64 on ``device``, the zero mode pinned to 0 (a mean-free
  solution).  Real: the stencil is symmetric."""
  k = torch.as_tensor(2.0 * np.pi * np.fft.fftfreq(n), device=device)
  c = 2.0 * torch.cos(k)
  lam = (c[:, None] + c[None, :] - 4.0) / h ** 2
  return torch.where(lam == 0.0, 0.0, 1.0 / torch.where(lam == 0.0, 1.0, lam))


def solve(f, h: float = 1.0):
  """Solve ``∇²u = f`` (periodic, mean-free): ``u = F⁻¹[F[f] / λ(k)]``,
  one lazy chain."""
  f = sp.lazify(f)
  n = f.shape[0]
  sym = sp.Val(SpartanArray(_inv_laplacian_symbol(n, h,
                                                  sp.get_mesh().device)))
  return sp.real(sp.fft.ifft2(sp.fft.fft2(f) * sym))


def laplacian(u, h: float = 1.0):
  """The periodic 5-point Laplacian, by rolls."""
  u = sp.lazify(u)
  return (sp.roll(u, 1, axis=0) + sp.roll(u, -1, axis=0)
          + sp.roll(u, 1, axis=1) + sp.roll(u, -1, axis=1)
          - 4.0 * u) / h ** 2


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


def run(n: int = 256, seed: int = 0):
  """The spectral solve of a mean-free random ``f``: ``(max |∇²u - f|,
  std(u))``, the residual through the lazy DAG."""
  rng = np.random.default_rng(seed)
  f = rng.standard_normal((n, n))
  f -= f.mean()  # the periodic problem's solvability condition
  u = solve(sp.from_numpy(f))
  res = sp.max(sp.abs(laplacian(u) - sp.from_numpy(f)))
  return float(res.glom()), float(sp.std(u).glom())
