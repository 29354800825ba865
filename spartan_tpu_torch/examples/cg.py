"""Conjugate gradient for SPD systems (port of
``spartan_tpu/examples/cg.py``).

Two paths:

* ``solve``: alpha and beta are read on the host every iteration, as the
  reference's driver loop does (each ``glom`` is a sync);
* ``solve_fused``: one ``sp.while_loop`` iterating to tolerance; its
  condition is read on the host once an iteration.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def solve(A, b, iterations: int = 50, tol: float = 1e-10):
  """Solve ``A x = b`` for SPD A (SpartanArray/expr/numpy inputs)."""
  A, b = sp.lazify(A), sp.lazify(b)
  n = b.shape[0]
  x = sp.zeros((n,), dtype=np.float64)
  r = sp.Val((b - sp.dot(A, x)).evaluate())
  p = r
  rs_old = float(sp.dot(r, r).glom())
  for _ in range(iterations):
    Ap = sp.Val(sp.dot(A, p).evaluate())
    alpha = rs_old / float(sp.dot(p, Ap).glom())
    x = sp.Val((x + alpha * p).evaluate())
    r = sp.Val((r - alpha * Ap).evaluate())
    rs_new = float(sp.dot(r, r).glom())
    if np.sqrt(rs_new) < tol:
      break
    p = sp.Val((r + (rs_new / rs_old) * p).evaluate())
    rs_old = rs_new
  return x.evaluate()


def solve_fused(A, b, tol: float = 1e-10, max_iters: int = 1000):
  """CG in one ``sp.while_loop`` iterating to tolerance (contrast
  :func:`solve`, which pulls alpha/beta to the host every iteration)."""
  A, b = sp.lazify(A), sp.lazify(b)
  n = b.shape[0]
  b_arr = b.evaluate()

  def cond(x, r, p, rs):
    return sp.sqrt(rs) > tol

  def body(x, r, p, rs):
    Ap = sp.dot(A, p)
    alpha = rs / sp.dot(p, Ap)
    x2 = x + alpha * p
    r2 = r - alpha * Ap
    rs2 = sp.dot(r2, r2)
    p2 = r2 + (rs2 / rs) * p
    return x2, r2, p2, rs2

  rs0 = sp.dot(b, b).evaluate()
  x, r, p, rs = sp.while_loop(
      cond, body,
      (sp.zeros((n,), dtype=np.float64), sp.Val(b_arr), sp.Val(b_arr),
       sp.Val(rs0)),
      max_iters=max_iters)
  return x


def make_spd(n: int = 128, seed: int = 0):
  rng = np.random.default_rng(seed)
  Q = rng.standard_normal((n, n))
  A = Q @ Q.T + n * np.eye(n)
  x_true = rng.standard_normal(n)
  return A, A @ x_true, x_true


def run(n: int = 128, iterations: int = 60):
  A, b, x_true = make_spd(n)
  x = solve(sp.from_numpy(A), sp.from_numpy(b), iterations)
  return x, x_true
