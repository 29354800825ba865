"""2-D heat equation (explicit Euler diffusion), port of
``spartan_tpu/examples/heat.py``.

Two paths:

* ``simulate``: the 5-point Laplacian as a single-channel ``sp.stencil``
  (the shifted-add emission) inside ``sp.make_fori``, any float dtype;
* ``simulate_padded``: the whole step ``u + alpha·lap(u)`` as one 3×3
  stencil over padded float32 storage, one launch of kernel K6a
  (``backend/kernels/stencil.stencil3x3_padded``) per step on the card.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import stencil as K


def step(u, alpha: float = 0.1):
  """One explicit Euler step of u_t = alpha * laplace(u), zero-boundary."""
  lap = np.array([[0.0, 1.0, 0.0],
                  [1.0, -4.0, 1.0],
                  [0.0, 1.0, 0.0]])
  u = sp.lazify(u)
  u4 = u.reshape((1, 1) + tuple(u.shape))
  out = u4 + alpha * sp.stencil(u4, sp.Val(lap.reshape(1, 1, 3, 3)))
  return out.reshape(tuple(u.shape))


def simulate(u0, iters: int = 100, alpha: float = 0.1):
  """Run ``iters`` diffusion steps as one cached ``make_fori`` step."""
  run = sp.make_fori(lambda u: step(u, alpha), sp.lazify(u0))
  return run(iters)


def simulate_padded(u0, iters: int = 100, alpha: float = 0.1,
                    unroll: int = 8):
  """``iters`` diffusion steps over padded float32 storage on the mesh's
  device: the step is the stencil ``[[0,a,0],[a,1-4a,a],[0,a,0]]``, one
  kernel pass, the zero ring kept by writing interiors only.  ``unroll``
  steps go to each call of the kernel wrapper.  ``u0`` is an (n, m) array
  (numpy or a tensor); returns the final field as numpy float32."""
  a = float(alpha)
  coeffs = (0.0, a, 0.0, a, 1.0 - 4.0 * a, a, 0.0, a, 0.0)
  u = torch.as_tensor(u0 if isinstance(u0, torch.Tensor) else np.asarray(u0),
                      dtype=torch.float32, device=sp.get_mesh().device)
  xp = K.to_padded(u)
  buf = torch.zeros_like(xp)
  done = 0
  while done < iters:
    k = min(unroll, iters - done)
    xp, buf = K.stencil3x3_padded(xp, buf, coeffs, steps=k)
    done += k
  return K.from_padded(xp).cpu().numpy()


def simulate_numpy(u0, iters: int = 100, alpha: float = 0.1):
  u = np.asarray(u0, dtype=np.float64).copy()
  for _ in range(iters):
    up = np.pad(u, 1)
    lap = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
           - 4.0 * u)
    u = u + alpha * lap
  return u


def run(n: int = 256, iters: int = 200, seed: int = 0):
  rng = np.random.default_rng(seed)
  u0 = np.zeros((n, n))
  # a few hot spots diffusing outwards
  for _ in range(8):
    i, j = rng.integers(8, n - 8, 2)
    u0[i, j] = 100.0
  got = np.asarray(simulate(u0, iters).glom())
  want = simulate_numpy(u0, iters)
  err = float(np.abs(got - want).max())
  return err, float(got.sum())
