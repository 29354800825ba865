"""``sp.scipy_linalg``: the ``scipy.linalg`` surface over the lazy layer (port
of ``spartan_tpu/scipy_linalg.py``).

Four kinds of name, as in the reference:

* **On-device names** (``expm``, ``expm_frechet``, ``lu``, ``lu_factor``,
  ``lu_solve``, ``cho_factor``, ``cho_solve``, ``polar``,
  ``eigh_tridiagonal``, ``block_diag``, ``khatri_rao``, ``pinvh``, and
  ``rq``, ``orthogonal_procrustes``, ``fractional_matrix_power``,
  ``matmul_toeplitz``, ``solve_circulant`` further down): each a lazy map
  over ``torch.linalg`` (cuSOLVER and cuBLAS on the card), where the
  reference maps ``jax.scipy.linalg`` (XLA computes them with no Pallas
  kernel).  The factorizations use the ``_ex`` forms, which check nothing on
  the host.  ``lu_factor`` returns scipy's 0-based pivots, as the reference
  does (torch's are LAPACK's 1-based ones), and ``lu_solve`` takes them.
  ``expm_frechet`` is the exponential of the block matrix ``[[A, E], [0,
  A]]``, whose upper right block is the Frechet derivative; ``polar`` is
  scipy's SVD form (the reference runs jax's QDWH, whose shape limits by
  side the port does not have).  ``matmul_toeplitz`` goes through
  ``sp.fft``.
* **Constructors and diagnostics** (``toeplitz`` … ``leslie``,
  ``diagsvd``, ``hadamard``, ``invpascal``, ``bandwidth``,
  ``issymmetric``, ``ishermitian``): lazy gathers and elementwise exprs, or
  small host constructions uploaded once; the exact integer matrices
  (``pascal``/``invpascal``/``invhilbert`` with ``exact=True``, an integer
  ``hadamard``) stay NumPy arrays on the host, as in the reference.
* **Matrix functions on the device** (``sqrtm``, ``logm``, ``signm``,
  ``cosm`` … ``tanhm``, ``orth``, ``null_space``): ``sqrtm`` is
  determinant-scaled Denman–Beavers, ``logm`` inverse scaling and squaring
  with a 16-node Gauss–Legendre quadrature, ``signm`` scaled Newton; each
  is one map whose emitter loops in torch and **reads its stopping residual
  on the host once a turn** (a few to a few dozen turns, each of several
  n³ factorizations).  The kernel packs a relative residual into an extra
  row; ``_matfun_gated`` reads it and, where it fails the gate (eigenvalues
  on the principal branch cut, where the function is complex), takes
  scipy's host path: the reference's semantics.  Each such fallback is
  counted in ``counts["matfun_host_fallbacks"]``; a complex input goes to
  the host up front, as in the reference, counted in
  ``counts["matfun_complex_host"]``; a result the device gave is counted
  in ``counts["matfun_device"]``.  ``cosm`` … ``tanhm`` are combinations of
  ``torch.linalg.matrix_exp``; ``orth``/``null_space`` are SVDs whose
  singular values alone are read for the rank cut.
* **Host boundaries** (``schur``, ``rsf2csf``, ``hessenberg``, ``funm``,
  the Sylvester, Lyapunov and Riccati solvers, ``ldl``, the banded solvers,
  ``qz``, ``ordqz``, ``cossin``, ``qr_update`` and the rest): scipy on the
  host, either a ``HostExpr`` (counted in ``expr.fio.counts["host_runs"]``
  when it runs) or, for the eager utilities, a direct call counted there
  too; each noticed once a process, as ``sp.linalg.eig`` is.  A name the
  installed scipy lacks raises scipy's own ``AttributeError``.

The reference's replication guard and its ``_fft_localize`` sharding
constraint have nothing to do here: dense arrays are whole tensors on the
mesh's one device.  Non-conflicting names are merged into ``sp.linalg`` by
the package ``__init__``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.fio import HostExpr
from spartan_tpu_torch.expr.map import structural
from spartan_tpu_torch.linalg import _lin_multi
from spartan_tpu_torch.util import log_info

__all__ = [
    # on the device (torch.linalg through lazy maps)
    "expm", "expm_frechet", "lu", "lu_factor", "lu_solve",
    "cho_factor", "cho_solve", "polar", "eigh_tridiagonal",
    "block_diag", "khatri_rao", "pinvh",
    # lazy constructors
    "toeplitz", "circulant", "hankel", "companion", "hilbert",
    "invhilbert", "helmert", "fiedler", "fiedler_companion",
    "convolution_matrix", "pascal", "dft", "leslie",
    # structure diagnostics (eager scalars, scipy's contract)
    "bandwidth", "issymmetric", "ishermitian",
    # matrix functions on the device (residual-gated host fallback)
    "sqrtm", "logm", "signm",
    "cosm", "sinm", "tanm", "coshm", "sinhm", "tanhm",
    "orth", "null_space",
    # host boundaries
    "schur", "rsf2csf", "hessenberg", "funm",
    "solve_sylvester", "solve_continuous_lyapunov", "solve_lyapunov",
    "solve_discrete_lyapunov", "ldl", "solve_banded", "solveh_banded",
    "subspace_angles", "matrix_balance",
]

# device results of the gated matrix functions, host fallbacks where the
# packed residual failed the gate, and complex inputs sent to the host
counts = {"matfun_device": 0, "matfun_host_fallbacks": 0,
          "matfun_complex_host": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def _inexact(a: torch.Tensor) -> torch.Tensor:
  """``a`` in ``jnp.result_type(a.dtype, float32)``: float64 and complex
  stay, everything else computes in float32, as the reference's kernels
  do."""
  if a.dtype in (torch.float64, torch.complex64, torch.complex128,
                 torch.float32):
    return a
  return a.to(torch.float32)


def _complex_of(dt: torch.dtype) -> torch.dtype:
  return torch.complex128 if dt == torch.float64 else torch.complex64


# ---------------------------------------------------------------------
# on the device: torch.linalg through lazy maps
# ---------------------------------------------------------------------

@structural
def _expm_k(a):
  return torch.linalg.matrix_exp(_inexact(a))


def expm(A):
  """Matrix exponential (Padé with scaling and squaring, products on the
  device).  For the action ``exp(tA) @ B`` without forming it, use
  :func:`sp.sparse.linalg.expm_multiply`."""
  return sp.map([sp.lazify(A)], _expm_k)


def expm_frechet(A, E):
  """``(expm(A), L(A, E))``: the exponential and its Frechet derivative in
  direction ``E`` (scipy.linalg.expm_frechet's contract)."""
  A, E = sp.lazify(A), sp.lazify(E)
  n = A.shape[0]
  st = sp.map([A, E], _frechet_stacked)
  return st[:n], st[n:]


@structural
def _frechet_stacked(a, e):
  """``[expm(a); L(a, e)]`` from the exponential of ``[[a, e], [0, a]]``,
  whose upper right block is the Frechet derivative."""
  dt = torch.promote_types(_inexact(a).dtype, _inexact(e).dtype)
  n = a.shape[-1]
  big = torch.zeros((2 * n, 2 * n), dtype=dt, device=a.device)
  big[:n, :n] = a
  big[n:, n:] = a
  big[:n, n:] = e
  out = torch.linalg.matrix_exp(big)
  return torch.cat([out[:n, :n], out[:n, n:]], dim=0)


def _lu(a, permute_l=False):
  p, l, u = torch.linalg.lu(_inexact(a))
  return (p @ l, u) if permute_l else (p, l, u)


def lu(A, permute_l: bool = False):
  """LU with partial pivoting: ``(p, l, u)`` with ``p @ l @ u == A`` (or
  ``(pl, u)`` when ``permute_l``), one factorization for all outputs."""
  n_out = 2 if permute_l else 3
  return _lin_multi(A, _lu, n_out, permute_l=bool(permute_l))


def _lu_factor(a):
  """``(lu, piv)`` with scipy's 0-based int32 pivots (torch's are
  LAPACK's, 1-based)."""
  lu_, piv, _ = torch.linalg.lu_factor_ex(_inexact(a))
  return lu_, piv - 1


def lu_factor(A):
  """``(lu, piv)`` packed factorization for :func:`lu_solve`: ``piv`` is
  0-based, row i was interchanged with row ``piv[i]`` (scipy's)."""
  return _lin_multi(A, _lu_factor, 2)


@structural
def _lu_solve_k(lu_, piv, b, trans=0):
  dt = torch.promote_types(lu_.dtype, b.dtype)
  lu_ = lu_.to(dt)
  vec = b.ndim == 1
  B = (b[:, None] if vec else b).to(dt)
  pivots = piv.to(torch.int32) + 1
  if trans == 0:
    x = torch.linalg.lu_solve(lu_, pivots, B)
  elif trans == 2 or not dt.is_complex:
    x = torch.linalg.lu_solve(lu_, pivots, B, adjoint=True)
  else:  # A^T x = b for complex A: conj(A^H conj(x)) = b
    x = torch.linalg.lu_solve(lu_, pivots, B.conj_physical(),
                              adjoint=True).conj_physical()
  return x[:, 0] if vec else x


def lu_solve(lu_and_piv, b, trans: int = 0):
  """Solve ``A x = b`` (``trans`` 1: ``A^T x = b``, 2: ``A^H x = b``) from
  a :func:`lu_factor` result with 0-based pivots."""
  lu_, piv = lu_and_piv
  if int(trans) not in (0, 1, 2):
    raise ValueError(f"trans must be 0, 1 or 2, got {trans!r}")
  return sp.map([sp.lazify(lu_), sp.lazify(piv), sp.lazify(b)],
                _lu_solve_k, fn_kw={"trans": int(trans)})


@structural
def _cho_factor_k(a, lower=False):
  return torch.linalg.cholesky_ex(_inexact(a), upper=not lower).L


def cho_factor(A, lower: bool = False):
  """``(c, lower)`` for :func:`cho_solve`: ``c`` holds the factor in the
  ``lower`` (or upper) triangle and zeros in the other (scipy's contract
  leaves the other triangle unspecified)."""
  c = sp.map([sp.lazify(A)], _cho_factor_k, fn_kw={"lower": bool(lower)})
  return c, bool(lower)


@structural
def _cho_solve_k(c, b, lower=False):
  dt = torch.promote_types(c.dtype, b.dtype)
  vec = b.ndim == 1
  B = (b[:, None] if vec else b).to(dt)
  x = torch.cholesky_solve(B, c.to(dt), upper=not lower)
  return x[:, 0] if vec else x


def cho_solve(c_and_lower, b):
  """Solve ``A x = b`` from a :func:`cho_factor` result."""
  c, lower = c_and_lower
  return sp.map([sp.lazify(c), sp.lazify(b)], _cho_solve_k,
                fn_kw={"lower": bool(lower)})


def _polar(a, side="right"):
  w, s, vh = torch.linalg.svd(_inexact(a), full_matrices=False)
  u = w @ vh
  s = s.to(w.dtype)
  if side == "right":
    return u, (vh.mH * s) @ vh
  return u, (w * s) @ w.mH


def polar(A, side: str = "right"):
  """Polar decomposition ``(u, p)``: ``u @ p == A`` (``side='right'``) or
  ``p @ u == A`` (``'left'``), by scipy's SVD form, any shape."""
  if side not in ("right", "left"):
    raise ValueError("`side` must be either 'right' or 'left'")
  return _lin_multi(A, _polar, 2, side=str(side))


@structural
def _eigh_tridiagonal_k(d, e):
  dt = torch.promote_types(_inexact(d).dtype, _inexact(e).dtype)
  t = (torch.diag(d.to(dt)) + torch.diag(e.to(dt), 1)
       + torch.diag(e.to(dt), -1))
  return torch.linalg.eigvalsh(t)


def eigh_tridiagonal(d, e):
  """Eigenvalues of a symmetric tridiagonal matrix (ascending), values
  only as in the reference (for vectors, ``sp.linalg.eigh`` of the dense
  matrix)."""
  return sp.map([sp.lazify(d), sp.lazify(e)], _eigh_tridiagonal_k)


@structural
def _block_diag_k(*xs):
  dt = xs[0].dtype
  for x in xs[1:]:
    dt = torch.promote_types(dt, x.dtype)
  return torch.block_diag(*[x.to(dt) for x in xs])


def block_diag(*arrs):
  """Block-diagonal matrix of the given blocks (a 1-D block is a row)."""
  if not arrs:
    return sp.zeros((1, 0))
  return sp.map([sp.lazify(a) for a in arrs], _block_diag_k)


def khatri_rao(a, b):
  """Column-wise Kronecker product: ``(k*l, n)`` from ``(k, n)``/``(l, n)``,
  lazy elementwise ops."""
  a, b = sp.lazify(a), sp.lazify(b)
  k, n = a.shape
  l, n2 = b.shape
  if n != n2:
    raise ValueError(f"khatri_rao: column counts differ ({n} vs {n2})")
  return sp.reshape(a[:, None, :] * b[None, :, :], (k * l, n))


@structural
def _pinvh_k(a, rtol=None):
  a = _inexact(a)
  w, v = torch.linalg.eigh(a)
  tol = (torch.finfo(w.dtype).eps * a.shape[0] if rtol is None
         else rtol) * w.abs().max()
  inv_w = torch.where(w.abs() > tol,
                      1.0 / torch.where(w == 0, torch.ones_like(w), w),
                      torch.zeros_like(w))
  return (v * inv_w.to(v.dtype)[None, :]) @ v.mH


def pinvh(A, rtol=None):
  """Pseudo-inverse of a symmetric/Hermitian matrix: one eigh, the cut,
  the recomposition, on the device."""
  return sp.map([sp.lazify(A)], _pinvh_k,
                fn_kw=None if rtol is None else {"rtol": float(rtol)})


# ---------------------------------------------------------------------
# lazy structured-matrix constructors
# ---------------------------------------------------------------------

def toeplitz(c, r=None):
  """Toeplitz matrix: first column ``c``, first row ``r`` (default
  ``conj(c)`` with ``r[0] = c[0]``), a gather over the generator vector
  ``[c reversed, r[1:]]``: ``T[i, j] = g[(n-1) - i + j]``."""
  c = sp.lazify(c)
  n = c.shape[0]
  if r is None:
    r = sp.conj(c)
  r = sp.lazify(r)
  m = r.shape[0]
  g = sp.concatenate([c[::-1], r[1:]])
  idx = (n - 1) - np.arange(n)[:, None] + np.arange(m)[None, :]
  return g[idx]


def circulant(c):
  """Circulant matrix: ``C[i, j] = c[(i - j) % n]``."""
  c = sp.lazify(c)
  n = c.shape[0]
  idx = (np.arange(n)[:, None] - np.arange(n)[None, :]) % n
  return c[idx]


def hankel(c, r=None):
  """Hankel matrix: ``H[i, j] = g[i + j]`` with ``g = [c, r[1:]]`` (``r``
  defaults to zeros, scipy's contract)."""
  c = sp.lazify(c)
  n = c.shape[0]
  if r is None:
    r = sp.zeros((n,), dtype=c.dtype)
  r = sp.lazify(r)
  m = r.shape[0]
  g = sp.concatenate([c, r[1:]])
  idx = np.arange(n)[:, None] + np.arange(m)[None, :]
  return g[idx]


def companion(a):
  """Companion matrix of polynomial coefficients ``a`` (length n ≥ 2).  A
  zero leading coefficient raises when ``a`` is concrete."""
  if isinstance(a, (np.ndarray, list, tuple)):
    a0 = np.asarray(a).ravel()
    if a0.size and a0[0] == 0:
      raise ValueError("companion: first coefficient must not be zero")
  a = sp.lazify(a)
  n = a.shape[0]
  if n < 2:
    raise ValueError("companion: need at least 2 coefficients")
  first = -a[1:] / a[0]
  body = (sp.eye(n - 2, n - 1, dtype=first.dtype) if n > 2
          else sp.zeros((0, n - 1), dtype=first.dtype))
  return sp.concatenate([sp.reshape(first, (1, n - 1)), body], axis=0)


def fiedler(a):
  """Symmetric Fiedler matrix ``F[i, j] = |a[i] - a[j]|``."""
  a = sp.lazify(a)
  return sp.absolute(a[:, None] - a[None, :])


def fiedler_companion(a):
  """Fiedler companion matrix (a small host construction, uploaded)."""
  import scipy.linalg as sla
  return sp.from_numpy(sla.fiedler_companion(np.asarray(sp.lazify(a).glom())))


def hilbert(n: int):
  """Hilbert matrix ``H[i, j] = 1 / (i + j + 1)``, lazy."""
  i = sp.arange(n, dtype=np.float64)
  return 1.0 / (i[:, None] + i[None, :] + 1.0)


def invhilbert(n: int, exact: bool = False):
  """Inverse Hilbert matrix (host integer combinatorics): ``exact=True``
  returns the exact host NumPy array (integers past int64 cannot live on
  the device); ``exact=False`` a float expr."""
  import scipy.linalg as sla
  m = sla.invhilbert(int(n), exact=exact)
  return m if exact else sp.from_numpy(m)


def helmert(n: int, full: bool = False):
  """Helmert orthogonal matrix (a small host construction)."""
  import scipy.linalg as sla
  return sp.from_numpy(sla.helmert(int(n), full=full))


def convolution_matrix(a, n: int, mode: str = "full"):
  """Convolution matrix ``A`` with ``A @ v == convolve(a, v, mode)``, a
  masked Toeplitz-style gather; ``same``/``valid`` trim relative to the
  shorter operand, as ``np.convolve`` does."""
  a = sp.lazify(a)
  k = a.shape[0]
  if mode not in ("full", "same", "valid"):
    raise ValueError(f"unknown mode {mode!r}")
  rows = {"full": k + n - 1, "same": max(k, n),
          "valid": max(k, n) - min(k, n) + 1}[mode]
  offset = {"full": 0, "same": (min(k, n) - 1) // 2,
            "valid": min(k, n) - 1}[mode]
  ii = np.arange(rows)[:, None] + offset
  jj = np.arange(n)[None, :]
  idx = ii - jj
  valid = (idx >= 0) & (idx < k)
  g = sp.concatenate([a, sp.zeros((1,), dtype=a.dtype)])
  return g[np.where(valid, idx, k)]


def pascal(n: int, kind: str = "symmetric", exact: bool = False):
  """Pascal matrix (host integer combinatorics): ``exact=True`` returns the
  exact host array (scipy's object dtype past n = 34), ``exact=False`` a
  float expr."""
  import scipy.linalg as sla
  m = sla.pascal(int(n), kind=kind, exact=exact)
  return m if exact else sp.from_numpy(np.asarray(m, float))


def dft(n: int, scale=None):
  """DFT matrix (complex, a host construction uploaded)."""
  import scipy.linalg as sla
  return sp.from_numpy(sla.dft(int(n), scale=scale))


def leslie(f, s):
  """Leslie population-model matrix (a small host construction)."""
  import scipy.linalg as sla
  return sp.from_numpy(sla.leslie(np.asarray(sp.lazify(f).glom()),
                                  np.asarray(sp.lazify(s).glom())))


# ---------------------------------------------------------------------
# structure diagnostics: eager scalars (scipy's contract)
# ---------------------------------------------------------------------

def bandwidth(A):
  """``(lo, hi)`` bandwidths: masked max-reductions, ints out."""
  A = sp.lazify(A)
  n, m = A.shape
  off = np.arange(n)[:, None] - np.arange(m)[None, :]  # i - j
  nz = sp.not_equal(A, 0)
  zero = sp.lazify(np.zeros_like(off))
  lo = sp.max(sp.where(nz, sp.lazify(off), zero))
  hi = sp.max(sp.where(nz, sp.lazify(-off), zero))
  return int(np.asarray(lo.glom())), int(np.asarray(hi.glom()))


def issymmetric(A, atol: float = 0.0, rtol: float = 0.0):
  A = sp.lazify(A)
  if atol or rtol:
    d = sp.max(sp.absolute(A - sp.transpose(A)))
    bound = atol + rtol * float(np.asarray(sp.max(sp.absolute(A)).glom()))
    return bool(float(np.asarray(d.glom())) <= bound)
  return bool(np.asarray(sp.all(sp.equal(A, sp.transpose(A))).glom()))


def ishermitian(A, atol: float = 0.0, rtol: float = 0.0):
  A = sp.lazify(A)
  if not _is_complex(A):
    return issymmetric(A, atol=atol, rtol=rtol)
  d = sp.max(sp.absolute(A - sp.conj(sp.transpose(A))))
  if atol or rtol:
    bound = atol + rtol * float(np.asarray(sp.max(sp.absolute(A)).glom()))
    return bool(float(np.asarray(d.glom())) <= bound)
  return bool(float(np.asarray(d.glom())) == 0.0)


# ---------------------------------------------------------------------
# matrix functions on the device.  Each kernel is one map whose emitter
# loops in torch, reading its stopping residual on the host once a turn,
# and packs a relative residual into an extra output row; the wrapper reads
# that one scalar and takes scipy's host path where the iteration's branch
# assumptions failed (eigenvalues on the closed negative real axis for
# sqrtm/logm, on the imaginary axis for signm).
# ---------------------------------------------------------------------

_MATFUN_MAX_ITER = 48


def _fro(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.matrix_norm(x)


def _inv(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.inv_ex(x).inverse


def _db_sqrt(a, eye, max_iter):
  """Determinant-scaled Denman–Beavers: ``(Y ≈ A^{1/2}, Z ≈ A^{-1/2},
  relres)``.  The scale ``mu = |det Y det Z|^{-1/(2n)}`` (through slogdet)
  speeds the early steps and tends to 1.  The loop stops when the
  residual, read on the host each turn, meets ``10 n eps`` or is NaN."""
  n = a.shape[0]
  na = _fro(a)
  na = torch.where(na == 0, torch.ones_like(na), na)
  tol = 10.0 * n * torch.finfo(a.dtype).eps

  def rel(y):
    return _fro(y @ y - a) / na

  y, z, r, k = a, eye, rel(a), 0
  while k < max_iter and float(r) > tol:
    ldy = torch.linalg.slogdet(y).logabsdet
    ldz = torch.linalg.slogdet(z).logabsdet
    mu = torch.exp(-(ldy + ldz) / (2.0 * n)).to(a.dtype)
    yi, zi = _inv(mu * y), _inv(mu * z)
    y, z = 0.5 * (mu * y + zi), 0.5 * (mu * z + yi)
    r, k = rel(y), k + 1
  return y, z, r


def _packed(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
  return torch.cat([x, r.to(x.dtype).expand(1, x.shape[1])], dim=0)


def _meta_packed(a):
  """The packed result's abstract value: ``(n + 1, n)``."""
  n = a.shape[0]
  return torch.empty((n + 1, n), dtype=_inexact(a).dtype, device="meta")


@structural
def _sqrtm_kernel(a):
  if a.device.type == "meta":
    return _meta_packed(a)
  a = _inexact(a)
  eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
  y, _, r = _db_sqrt(a, eye, _MATFUN_MAX_ITER)
  return _packed(y, r)


@structural
def _logm_kernel(a, nodes=(), weights=()):
  """Inverse scaling and squaring: principal square roots (each a
  Denman–Beavers loop) until ``||A^(1/2^k) - I||_1 < 0.4``, then the
  16-node Gauss–Legendre quadrature of ``log(I+X) = ∫ X (tX + I)^{-1}
  dt``, times ``2^k``.  Residual ``||expm(result) - A|| / ||A||``."""
  if a.device.type == "meta":
    return _meta_packed(a)
  a = _inexact(a)
  n = a.shape[0]
  eye = torch.eye(n, dtype=a.dtype, device=a.device)
  na = _fro(a)
  na = torch.where(na == 0, torch.ones_like(na), na)

  def dist(x):
    return (x - eye).abs().sum(0).max()

  x, k = a, 0
  while k < 40 and float(dist(x)) > 0.4:  # a NaN distance ends the loop
    x, _, _ = _db_sqrt(x, eye, _MATFUN_MAX_ITER)
    k += 1
  xm = x - eye
  acc = torch.zeros_like(a)
  for t, w in zip(nodes, weights):
    acc = acc + w * (xm @ _inv(t * xm + eye))
  out = (2.0 ** k) * acc
  r = _fro(torch.linalg.matrix_exp(out) - a) / na
  return _packed(out, r)


@structural
def _signm_kernel(a):
  """Scaled Newton for the matrix sign: ``X ← (μX + (μX)^{-1})/2`` with
  ``μ = |det X|^{-1/n}``; residual ``||X² - I||_F / √n`` (a sign matrix is
  involutory)."""
  if a.device.type == "meta":
    return _meta_packed(a)
  a = _inexact(a)
  n = a.shape[0]
  eye = torch.eye(n, dtype=a.dtype, device=a.device)
  sqn = float(n) ** 0.5
  tol = 10.0 * n * torch.finfo(a.dtype).eps

  def rel(x):
    return _fro(x @ x - eye) / sqn

  x, r, k = a, rel(a), 0
  while k < _MATFUN_MAX_ITER and float(r) > tol:
    ld = torch.linalg.slogdet(x).logabsdet
    mu = torch.exp(-ld / n).to(a.dtype)
    x = 0.5 * (mu * x + _inv(mu * x))
    r, k = rel(x), k + 1
  return _packed(x, r)


def _gate_tol(dtype) -> float:
  """The residual separating a converged iteration (O(κ eps)) from a
  violated branch assumption (O(0.1) or NaN)."""
  return float(torch.finfo(dtype).eps ** 0.5 * 50.0)


def _is_complex(e) -> bool:
  return e.dtype.is_complex


_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(16)
_GL_NODES = tuple(((_GL_NODES + 1.0) / 2.0).tolist())     # → [0, 1]
_GL_WEIGHTS = tuple((_GL_WEIGHTS / 2.0).tolist())


def _matfun_gated(name, A, kernel, disp, kw=None):
  """Run the device kernel once, read its packed residual, and take
  scipy's host path where it fails the gate (counted)."""
  A = sp.lazify(A)
  n = A.shape[0]
  if _is_complex(A):
    counts["matfun_complex_host"] += 1
    X = _host_call(name, [A])
    return X if disp else (X, _host_errest(name, X, A))
  st = sp.Val(sp.map([A], kernel, fn_kw=kw).evaluate())
  res = float(np.asarray(st[n, 0].glom()))
  if np.isfinite(res) and res < _gate_tol(st.dtype):
    counts["matfun_device"] += 1
    X = st[:n]
    return X if disp else (X, res)
  counts["matfun_host_fallbacks"] += 1
  log_info(
      "sp.scipy_linalg.%s: device iteration did not converge "
      "(residual %.3g — eigenvalues on the principal-branch cut); "
      "falling back to the host Schur path.", name, res)
  X = _host_call(name, [A])
  return X if disp else (X, _host_errest(name, X, A))


def _host_errest(name, X, A):
  """scipy's ``disp=False`` error estimate for the host path."""
  X = sp.Val(sp.lazify(X).evaluate())  # the host op's result, run once
  if name == "sqrtm":
    d = sp.dot(X, X) - sp.lazify(A)
  elif name == "signm":
    d = sp.dot(X, X) - sp.lazify(np.eye(sp.lazify(A).shape[0]))
  else:  # logm: ||expm(L) - A|| needs a host expm of a complex X
    import scipy.linalg as sla
    Xn = np.asarray(sp.lazify(X).glom())
    An = np.asarray(sp.lazify(A).glom())
    return float(np.linalg.norm(sla.expm(Xn) - An)
                 / max(np.linalg.norm(An), 1e-300))
  num = float(np.asarray(sp.sum(sp.absolute(d) ** 2).glom())) ** 0.5
  den = float(np.asarray(
      sp.sum(sp.absolute(sp.lazify(A)) ** 2).glom())) ** 0.5
  return num / max(den, 1e-300)


def sqrtm(A, disp: bool = True, blocksize: int = 64):
  """Principal matrix square root: determinant-scaled Denman–Beavers on the
  device, scipy's host Schur path for spectra touching the closed negative
  real axis.  ``disp=False`` returns ``(X, errest)`` (the residual is
  packed in the kernel's output).  ``blocksize`` is scipy's recursion
  knob, accepted for the signature."""
  del blocksize
  return _matfun_gated("sqrtm", A, _sqrtm_kernel, disp)


def logm(A, disp: bool = True):
  """Principal matrix logarithm: inverse scaling and squaring with
  Gauss–Legendre quadrature on the device (``_logm_kernel``), the host
  path on the branch cut."""
  return _matfun_gated("logm", A, _logm_kernel, disp,
                       {"nodes": _GL_NODES, "weights": _GL_WEIGHTS})


def signm(A, disp: bool = True):
  """Matrix sign function: scaled Newton on the device, the host path for
  spectra touching the imaginary axis."""
  return _matfun_gated("signm", A, _signm_kernel, disp)


def _circular(a):
  """``expm(1j a)`` in the complex dtype of ``a``'s float."""
  a = _inexact(a)
  return torch.linalg.matrix_exp(1j * a.to(_complex_of(a.dtype)))


@structural
def _cosm_kernel(a):
  if a.is_complex():
    return 0.5 * (torch.linalg.matrix_exp(1j * a)
                  + torch.linalg.matrix_exp(-1j * a))
  return _circular(a).real


@structural
def _sinm_kernel(a):
  if a.is_complex():
    return (torch.linalg.matrix_exp(1j * a)
            - torch.linalg.matrix_exp(-1j * a)) / 2j
  return _circular(a).imag


@structural
def _tanm_kernel(a):
  if a.is_complex():
    e1, e2 = torch.linalg.matrix_exp(1j * a), torch.linalg.matrix_exp(-1j * a)
    return torch.linalg.solve_ex(0.5 * (e1 + e2), (e1 - e2) / 2j).result
  e = _circular(a)
  return torch.linalg.solve_ex(e.real, e.imag).result


@structural
def _coshm_kernel(a):
  a = _inexact(a)
  return 0.5 * (torch.linalg.matrix_exp(a) + torch.linalg.matrix_exp(-a))


@structural
def _sinhm_kernel(a):
  a = _inexact(a)
  return 0.5 * (torch.linalg.matrix_exp(a) - torch.linalg.matrix_exp(-a))


@structural
def _tanhm_kernel(a):
  a = _inexact(a)
  ep, em = torch.linalg.matrix_exp(a), torch.linalg.matrix_exp(-a)
  return torch.linalg.solve_ex(ep + em, ep - em).result


def cosm(A):
  """Matrix cosine ``(e^{iA} + e^{-iA})/2``, one map (complex inside for
  a real input, real out)."""
  return sp.map([sp.lazify(A)], _cosm_kernel)


def sinm(A):
  """Matrix sine, one map."""
  return sp.map([sp.lazify(A)], _sinm_kernel)


def tanm(A):
  """Matrix tangent ``cosm(A)^{-1} sinm(A)`` (one exponential, one
  solve)."""
  return sp.map([sp.lazify(A)], _tanm_kernel)


def coshm(A):
  """Matrix hyperbolic cosine ``(e^A + e^{-A})/2``."""
  return sp.map([sp.lazify(A)], _coshm_kernel)


def sinhm(A):
  """Matrix hyperbolic sine ``(e^A - e^{-A})/2``."""
  return sp.map([sp.lazify(A)], _sinhm_kernel)


def tanhm(A):
  """Matrix hyperbolic tangent ``coshm(A)^{-1} sinhm(A)``."""
  return sp.map([sp.lazify(A)], _tanhm_kernel)


@structural
def _orth_pack_kernel(a):
  u, s, _ = torch.linalg.svd(_inexact(a), full_matrices=False)
  return torch.cat([u, s[None, :].to(u.dtype)], dim=0)


@structural
def _null_pack_kernel(a):
  _, s, vh = torch.linalg.svd(_inexact(a), full_matrices=True)
  srow = torch.zeros((1, vh.shape[1]), dtype=vh.dtype, device=vh.device)
  srow[0, :s.shape[0]] = s.to(vh.dtype)
  return torch.cat([vh, srow], dim=0)


def _svd_rank(s, shape, rcond) -> int:
  s = np.real(np.asarray(s))
  if s.size == 0:
    return 0
  eps = np.finfo(s.dtype).eps
  tol = (max(shape) * eps if rcond is None else float(rcond)) * float(s[0])
  return int(np.sum(s > tol))


def orth(A, rcond=None):
  """Orthonormal basis of the range: an SVD on the device, evaluated once;
  only the singular values are read for the rank cut, the ``(m, rank)``
  basis stays a lazy slice of the device result."""
  A = sp.lazify(A)
  m, n = A.shape
  st = sp.Val(sp.map([A], _orth_pack_kernel).evaluate())
  s = np.asarray(st[m].glom())[:min(m, n)]
  rank = _svd_rank(s, (m, n), rcond)
  return st[:m, :rank]


def null_space(A, rcond=None):
  """Orthonormal basis of the null space: a full SVD on the device; only
  the singular values are read, the ``(n, n - rank)`` basis stays lazy."""
  A = sp.lazify(A)
  m, n = A.shape
  st = sp.Val(sp.map([A], _null_pack_kernel).evaluate())
  s = np.asarray(st[n].glom())[:min(m, n)]
  rank = _svd_rank(s, (m, n), rcond)
  return sp.transpose(sp.conj(st[rank:n]))


# ---------------------------------------------------------------------
# host boundaries: the Schur family and the banded/LDL solvers (scipy on
# the host, the sp.linalg.eig convention)
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  """Say once a process that ``name`` runs on the host."""
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info(
      "sp.scipy_linalg.%s: no device kernel (Schur/banded family) — "
      "this evaluates EAGERLY on the host (scipy.linalg.%s), breaking "
      "the lazy chain at this node.", name, name)


def _host_eager(name, fn, *args, **kw):
  """An eager host utility: noticed once, counted as a host run."""
  _host_notice(name)
  fio.counts["host_runs"] += 1
  return fn(*args, **kw)


def _glommed(x) -> np.ndarray:
  return np.asarray(sp.lazify(x).glom())


def _rows(x) -> int:
  """``x``'s leading extent; a host op's output (whose shape is known only
  once it has run) is evaluated for it."""
  e = sp.lazify(x)
  try:
    return e.shape[0]
  except sp.NotShapeable:
    return e.evaluate().shape[0]


def _host_call(name, args, multi_n=0, stack_axis=0, **kw):
  """``scipy.linalg.<name>`` of the evaluated inputs as a ``HostExpr``;
  ``multi_n > 0``: the tuple of same-width outputs is stacked into one
  result (one host factorization) for the caller to slice apart."""
  import scipy.linalg as sla
  _host_notice(name)
  fn = getattr(sla, name)
  if multi_n == 0:
    return HostExpr([sp.lazify(a) for a in args],
                    functools.partial(_call_kw, fn, tuple(kw.items())))
  return HostExpr([sp.lazify(a) for a in args],
                  functools.partial(_stacked, fn, tuple(kw.items()),
                                    stack_axis))


def _call_kw(fn, kw, *xs):
  return fn(*xs, **dict(kw))


def _stacked(fn, kw, axis, *xs):
  outs = fn(*xs, **dict(kw))
  return np.concatenate([np.atleast_2d(np.asarray(o)) for o in outs],
                        axis=axis)


def schur(A, output: str = "real"):
  """Schur decomposition ``(t, z)`` on the host."""
  n = _rows(A)
  st = _host_call("schur", [A], multi_n=2, output=output)
  return st[:n], st[n:]


def rsf2csf(T, Z):
  """Real to complex Schur form on the host."""
  n = _rows(T)
  st = _host_call("rsf2csf", [T, Z], multi_n=2)
  return st[:n], st[n:]


def hessenberg(A, calc_q: bool = False):
  """Hessenberg form (with the similarity transform Q when ``calc_q``) on
  the host."""
  if not calc_q:
    return _host_call("hessenberg", [A])
  n = _rows(A)
  st = _host_call("hessenberg", [A], multi_n=2, calc_q=True)
  return st[:n], st[n:]


def funm(A, func):
  """General matrix function by Schur–Parlett on the host; ``func`` takes
  NumPy arrays."""
  import scipy.linalg as sla
  _host_notice("funm")
  return HostExpr([sp.lazify(A)], functools.partial(sla.funm, func=func))


def solve_sylvester(a, b, q):
  """Solve ``AX + XB = Q`` (Bartels–Stewart) on the host."""
  return _host_call("solve_sylvester", [a, b, q])


def solve_continuous_lyapunov(a, q):
  return _host_call("solve_continuous_lyapunov", [a, q])


solve_lyapunov = solve_continuous_lyapunov


def solve_discrete_lyapunov(a, q, method=None):
  import scipy.linalg as sla
  _host_notice("solve_discrete_lyapunov")
  return HostExpr([sp.lazify(a), sp.lazify(q)],
                  functools.partial(sla.solve_discrete_lyapunov,
                                    method=method))


def _ldl_stacked(n, lower, a):
  import scipy.linalg as sla
  l, d, perm = sla.ldl(a, lower=lower)
  return np.concatenate([l, d, np.broadcast_to(
      np.asarray(perm, l.dtype)[:, None], (n, n))], axis=0)


def ldl(A, lower: bool = True):
  """LDLᵀ factorization ``(lu, d, perm)`` on the host (LAPACK sytrf);
  ``perm`` a host int64 array."""
  _host_notice("ldl")
  n = _rows(A)
  st = HostExpr([sp.lazify(A)], functools.partial(_ldl_stacked, n, lower))
  lu_, d_ = st[:n], st[n:2 * n]
  perm = np.asarray(st[2 * n:, 0].glom()).astype(np.int64)
  return lu_, d_, perm


def _sb(lu_, ab, b):
  import scipy.linalg as sla
  return sla.solve_banded(lu_, ab, b)


def solve_banded(l_and_u, ab, b):
  """Banded solve (LAPACK gbsv) on the host."""
  _host_notice("solve_banded")
  return HostExpr([sp.lazify(ab), sp.lazify(b)],
                  functools.partial(_sb, tuple(l_and_u)))


def _shb(lower, ab, b):
  import scipy.linalg as sla
  return sla.solveh_banded(ab, b, lower=lower)


def solveh_banded(ab, b, lower: bool = False):
  _host_notice("solveh_banded")
  return HostExpr([sp.lazify(ab), sp.lazify(b)],
                  functools.partial(_shb, bool(lower)))


def subspace_angles(A, B):
  return _host_call("subspace_angles", [A, B])


def matrix_balance(A, permute: bool = True, scale: bool = True):
  """``(B, T)``, the balanced form and its transform, on the host
  (gebal)."""
  n = _rows(A)
  st = _host_call("matrix_balance", [A], multi_n=2,
                  permute=permute, scale=scale)
  return st[:n], st[n:]


# ---------------------------------------------------------------------
# the remaining scipy.linalg names: on the device where the math is a
# factorization, a product or an FFT (rq by a flipped QR,
# orthogonal_procrustes by an SVD, fractional_matrix_power by the gated
# logm/expm pair, circulant and Toeplitz products and solves by FFT); on
# the host for the LAPACK specialties (QZ, banded eigenproblems and
# Cholesky, Riccati, QR updates, Levinson)
# ---------------------------------------------------------------------

def eigvalsh_tridiagonal(d, e, select="a", select_range=None,
                         check_finite=True, tol=0.0, lapack_driver="auto"):
  """Eigenvalues of a symmetric tridiagonal matrix on the device (through
  :func:`eigh_tridiagonal`); ``select`` subsets raise, as in the
  reference."""
  del check_finite, tol, lapack_driver
  if select != "a" or select_range is not None:
    raise NotImplementedError(
        "eigvalsh_tridiagonal: select= subsets need the host "
        "eig_banded path")
  return eigh_tridiagonal(d, e)


def diagsvd(s, M: int, N: int):
  """``(M, N)`` rectangular diagonal of singular values, a lazy gather."""
  s = sp.lazify(s)
  k = s.shape[0]
  if k != min(M, N):
    raise ValueError(f"diagsvd: len(s)={k} != min(M, N)={min(M, N)}")
  g = sp.concatenate([s, sp.zeros((1,), dtype=s.dtype)])
  ii = np.arange(int(M))[:, None]
  jj = np.arange(int(N))[None, :]
  return g[np.where((ii == jj) & (ii < k), np.minimum(ii, k - 1), k)]


def hadamard(n: int, dtype=int):
  """Sylvester Hadamard matrix by the bit-parity closed form ``H[i, j] =
  (-1)^popcount(i & j)``.  An integer dtype returns the exact host array,
  a float dtype a device array (the reference's split)."""
  n = int(n)
  if n < 1 or (n & (n - 1)):
    raise ValueError("n must be a positive power of 2")
  i = np.arange(n)
  bits = i[:, None] & i[None, :]
  par = np.zeros_like(bits)
  while bits.any():
    par ^= bits & 1
    bits = bits >> 1
  H = np.where(par, -1, 1).astype(dtype)
  if np.issubdtype(np.dtype(dtype), np.floating):
    return sp.from_numpy(H)
  return H


def invpascal(n: int, kind: str = "symmetric", exact: bool = True):
  """Inverse Pascal matrix: ``exact=True`` returns the exact host array,
  ``exact=False`` a float expr."""
  import scipy.linalg as sla
  m = sla.invpascal(int(n), kind=kind, exact=exact)
  return m if exact else sp.from_numpy(np.asarray(m, float))


def clarkson_woodruff_transform(input_matrix, sketch_size: int,
                                rng=None, *, seed=None):
  """Count-sketch ``S @ A``: the signed one-hot sketch drawn on the host
  (scipy's generator contract), applied as one product on the device."""
  A = sp.lazify(input_matrix)
  m = A.shape[0]
  g = (rng if isinstance(rng, np.random.Generator)
       else np.random.default_rng(rng if rng is not None else seed))
  rows = g.integers(0, int(sketch_size), size=m)
  signs = g.integers(0, 2, size=m) * 2.0 - 1.0
  S = np.zeros((int(sketch_size), m))
  S[rows, np.arange(m)] = signs
  from spartan_tpu_torch.core.array import to_numpy_dtype
  return sp.dot(sp.lazify(S.astype(to_numpy_dtype(A.dtype), copy=False)), A)


@structural
def _procrustes_k(a, b):
  dt = torch.promote_types(_inexact(a).dtype, _inexact(b).dtype)
  u, s, vt = torch.linalg.svd(a.to(dt).mT @ b.to(dt))
  r = u @ vt
  return torch.cat([r, s.sum().to(r.dtype).expand(1, r.shape[1])], dim=0)


def orthogonal_procrustes(A, B, check_finite: bool = True):
  """``min_R ||A R - B||_F`` over orthogonal R: an SVD of ``Aᵀ B`` on the
  device; the rotation stays lazy, the scale row alone is read."""
  del check_finite
  A, B = sp.lazify(A), sp.lazify(B)
  st = sp.Val(sp.map([A, B], _procrustes_k).evaluate())
  n = A.shape[1]
  scale = float(np.asarray(st[n, 0].glom()))
  return st[:n], scale


@structural
def _rq_k(x, full=True):
  """RQ of ``x`` from the QR of its row-reversed transpose: reversing
  both axes of the triangular factor maps lower to upper; ``r`` is padded
  to ``x``'s width to pack ``[r; q]``."""
  x = _inexact(x)
  m, n = x.shape
  cols = n if full else min(m, n)
  q1, r1 = torch.linalg.qr(torch.flip(x, [0]).mT,
                           mode="complete" if full else "reduced")
  q = torch.flip(q1.mT, [0])
  r = torch.flip(r1.mT, [0, 1])
  if cols < n:
    r = torch.cat([r, torch.zeros((r.shape[0], n - cols), dtype=r.dtype,
                                  device=r.device)], dim=1)
  return torch.cat([r, q], dim=0)


def rq(a, overwrite_a=False, lwork=None, mode: str = "full",
       check_finite=True):
  """RQ decomposition ``A = R Q`` on the device by the flipped-QR
  identity; signs follow torch's QR (unique up to a sign a row;
  reconstruction and triangularity match scipy).  ``mode='r'`` returns R
  alone."""
  del overwrite_a, lwork, check_finite
  if mode not in ("full", "economic", "r"):
    raise ValueError(f"unknown mode {mode!r}")
  A = sp.lazify(a)
  m, n = A.shape
  full = mode == "full"
  cols = n if full else min(m, n)
  st = sp.map([A], _rq_k, fn_kw={"full": full})
  R = st[:m, :cols]
  if mode == "r":
    return R
  return R, st[m:]


@structural
def _matrix_power_k(x, n=1):
  return torch.linalg.matrix_power(_inexact(x), n)


def fractional_matrix_power(A, t):
  """``A^t``: an integer ``t`` is one ``matrix_power`` on the device (a
  negative one through the inverse); a fractional ``t`` composes the gated
  ``logm`` and ``expm`` (``expm(t·logm(A))``), the host path where the
  spectrum touches the principal branch cut."""
  A = sp.lazify(A)
  t = float(t)
  if _is_complex(A):
    return _host_call("fractional_matrix_power", [A], t=t)
  if t.is_integer():
    return sp.map([A], _matrix_power_k, fn_kw={"n": int(t)})
  L = logm(A)
  if isinstance(L, HostExpr):
    return _host_call("fractional_matrix_power", [A], t=t)
  return expm(t * L)


def _cr_pair(c_or_cr, what):
  if isinstance(c_or_cr, tuple):
    c, r = c_or_cr
    return sp.lazify(c), sp.lazify(r)
  c = sp.lazify(c_or_cr)
  if _is_complex(c):
    raise NotImplementedError(
        f"{what}: bare complex c (implicit r = conj(c)) goes to the host — "
        "pass (c, r) explicitly")
  return c, c


def _toeplitz_host(cc, rr, xx):
  import scipy.linalg as sla
  return sla.matmul_toeplitz((cc, rr), xx)


def matmul_toeplitz(c_or_cr, x, check_finite=False, workers=None):
  """Toeplitz @ x by circulant embedding through ``sp.fft`` (``rfft`` of
  the embedding and of x's zero-padded columns, their product, one
  ``irfft``): O((m+n) log(m+n)) against the O(mn) product.  Complex
  inputs go to the host."""
  del check_finite, workers
  c, r = _cr_pair(c_or_cr, "matmul_toeplitz")
  X = sp.lazify(x)
  if _is_complex(c) or _is_complex(r) or _is_complex(X):
    _host_notice("matmul_toeplitz")
    return HostExpr([c, r, X], _toeplitz_host)
  m, n = c.shape[0], r.shape[0]
  vec = len(X.shape) == 1
  if X.shape[0] != n:
    raise ValueError(f"x has {X.shape[0]} rows, needs {n}")
  L = m + n - 1
  # first circulant column: [c_0..c_{m-1}, r_{n-1}..r_1]; the transforms
  # run along the last axis of the transposed columns
  emb = sp.concatenate([c, sp.flip(r[1:], 0)])
  xt = sp.transpose(sp.reshape(X, (n, -1)))                 # (k, n)
  fx = sp.fft.rfft(xt, n=L, axis=1)
  fe = sp.fft.rfft(emb)
  out = sp.transpose(sp.fft.irfft(sp.reshape(fe, (1, -1)) * fx, n=L,
                                  axis=1)[:, :m])
  return out[:, 0] if vec else out


@structural
def _circ_extremes(cc):
  return torch.fft.fft(_inexact(cc)).abs().aminmax()


@structural
def _circ_solve_k(cc, bb, tol=None, lstsq=False):
  n = cc.shape[0]
  dt = torch.promote_types(_inexact(cc).dtype, _inexact(bb).dtype)
  fc = torch.fft.rfft(cc.to(dt))
  fb = torch.fft.rfft(bb.to(dt).reshape(n, -1).mT, dim=1)
  if lstsq:
    afc = fc.abs()
    cut = (tol if tol is not None
           else afc.max() * n * torch.finfo(afc.dtype).eps)
    q = torch.where((afc <= cut)[None, :], torch.zeros_like(fb),
                    fb / fc[None, :])
  else:
    q = fb / fc[None, :]
  out = torch.fft.irfft(q, n=n, dim=1).mT
  return out[:, 0] if bb.ndim == 1 else out


def solve_circulant(c, b, singular: str = "raise", tol=None,
                    caxis: int = -1, baxis: int = 0, outaxis: int = 0):
  """Solve ``circulant(c) x = b`` by FFT diagonalization in one map; the
  general broadcast/axis forms and complex inputs go to the host.
  ``singular='lstsq'`` zeroes the near-zero frequencies in the map;
  ``'raise'`` reads the two extreme |FFT| values first (scipy raises on
  the host)."""
  C, B = sp.lazify(c), sp.lazify(b)
  if (len(C.shape) != 1 or caxis not in (-1, 0) or baxis != 0
      or outaxis != 0 or _is_complex(C) or _is_complex(B)):
    import scipy.linalg as sla
    _host_notice("solve_circulant")
    return HostExpr([C, B], functools.partial(
        sla.solve_circulant, singular=singular, tol=tol,
        caxis=caxis, baxis=baxis, outaxis=outaxis))
  n = C.shape[0]
  if B.shape[0] != n:
    raise ValueError(f"b has {B.shape[0]} rows, needs {n}")
  if singular not in ("raise", "lstsq"):
    raise ValueError("singular must be 'raise' or 'lstsq'")
  if singular == "raise":
    ext = _lin_multi(C, _circ_extremes, 2)
    lo, hi = (float(np.asarray(e.glom())) for e in ext)
    t = float(tol) if tol is not None else (
        hi * n * np.finfo(np.float64).eps)
    if lo <= t:
      raise np.linalg.LinAlgError("Singular circulant matrix.")
  kw = {"lstsq": singular == "lstsq"}
  if tol is not None:
    kw["tol"] = float(tol)
  return sp.map([C, B], _circ_solve_k, fn_kw=kw)


def cdf2rdf(w, v):
  """Complex eigenpairs to the real block-diagonal form, on the host (the
  inputs come from the host ``eig``): ``a ± bi`` becomes ``[[a, b], [-b,
  a]]``, the pair's eigenvector's real and imaginary parts the two real
  columns, paired as scipy pairs them."""
  w = _glommed(w)
  v = _glommed(v)
  if w.ndim != 1 or v.ndim != 2:
    raise NotImplementedError("cdf2rdf: stacked inputs go through scipy")
  cm = np.flatnonzero(np.imag(w) != 0)
  if cm.size % 2:
    raise ValueError("expected complex-conjugate pairs of eigenvalues")
  j, k = cm[0::2], cm[1::2]
  M = np.diag(np.real(w))
  M[j, k] = np.imag(w[j])
  M[k, j] = np.imag(w[k])
  vr = np.real(v).copy()
  vr[:, j] = -0.5 * (np.imag(v[:, j]) - np.imag(v[:, k]))
  vr[:, k] = 0.5 * (np.real(v[:, j]) + np.real(v[:, k]))
  return M, vr


# --- the LAPACK specialties on the host ---------------------------------

def qz(A, B, output: str = "real", lwork=None, sort=None,
       overwrite_a=False, overwrite_b=False, check_finite=True):
  """Generalized Schur (QZ) on the host: one factorization, stacked
  ``(AA, BB, Q, Z)``."""
  del lwork, overwrite_a, overwrite_b, check_finite
  if sort is not None:
    raise ValueError("qz: sort= was removed by scipy; use ordqz")
  n = _rows(A)
  st = _host_call("qz", [A, B], multi_n=4, output=output)
  return st[:n], st[n:2 * n], st[2 * n:3 * n], st[3 * n:]


def ordqz(A, B, sort="lhp", output: str = "real",
          overwrite_a=False, overwrite_b=False, check_finite=True):
  """Reordered QZ, an eager host utility (its real and complex outputs do
  not stack into one result)."""
  del overwrite_a, overwrite_b, check_finite
  import scipy.linalg as sla
  return _host_eager("ordqz", sla.ordqz, _glommed(A), _glommed(B),
                     sort=sort, output=output)


def cossin(X, p=None, q=None, separate: bool = False,
           swap_sign: bool = False, compute_u: bool = True,
           compute_vh: bool = True):
  """Cosine-sine decomposition, an eager host utility (LAPACK uncsd)."""
  import scipy.linalg as sla
  if isinstance(X, (tuple, list)):
    xs = tuple(_glommed(x) for x in X)
  else:
    xs = _glommed(X)
  return _host_eager("cossin", sla.cossin, xs, p=p, q=q, separate=separate,
                     swap_sign=swap_sign, compute_u=compute_u,
                     compute_vh=compute_vh)


def eig_banded(a_band, lower=False, eigvals_only=False,
               overwrite_a_band=False, select="a", select_range=None,
               max_ev=0, check_finite=True):
  """Banded symmetric eigenproblem on the host (one stacked result: the
  w row, then the v block)."""
  del overwrite_a_band, check_finite
  if eigvals_only:
    return _host_call("eigvals_banded", [a_band], lower=lower,
                      select=select, select_range=select_range)
  if select != "a":
    raise NotImplementedError(
        "eig_banded select= subsets have data-dependent width; use "
        "eigvals_banded or host scipy directly")
  st = _host_call("eig_banded", [a_band], multi_n=2, lower=lower,
                  max_ev=max_ev)
  return st[0], st[1:]


def eigvals_banded(a_band, lower=False, overwrite_a_band=False,
                   select="a", select_range=None, check_finite=True):
  del overwrite_a_band, check_finite
  return _host_call("eigvals_banded", [a_band], lower=lower,
                    select=select, select_range=select_range)


def cholesky_banded(ab, overwrite_ab=False, lower=False,
                    check_finite=True):
  """Banded Cholesky on the host (returns the band form)."""
  del overwrite_ab, check_finite
  return _host_call("cholesky_banded", [ab], lower=lower)


def _cho_solve_banded(lower, c, bb):
  import scipy.linalg as sla
  return sla.cho_solve_banded((c, lower), bb)


def cho_solve_banded(cb_and_lower, b, overwrite_b=False,
                     check_finite=True):
  """Solve with a banded Cholesky factor on the host."""
  del overwrite_b, check_finite
  cb, lower = cb_and_lower
  _host_notice("cho_solve_banded")
  return HostExpr([sp.lazify(cb), sp.lazify(b)],
                  functools.partial(_cho_solve_banded, bool(lower)))


def _are(name, balanced, e, s, aa, bb, qq, rr):
  import scipy.linalg as sla
  return getattr(sla, name)(aa, bb, qq, rr, e=e, s=s, balanced=balanced)


def _riccati(name, a, b, q, r, e, s, balanced):
  if e is None and s is None:
    return _host_call(name, [a, b, q, r], balanced=balanced)
  _host_notice(name)
  return HostExpr([sp.lazify(x) for x in [a, b, q, r]],
                  functools.partial(
                      _are, name, balanced,
                      None if e is None else _glommed(e),
                      None if s is None else _glommed(s)))


def solve_continuous_are(a, b, q, r, e=None, s=None, balanced=True):
  """Continuous algebraic Riccati equation on the host (Schur-based)."""
  return _riccati("solve_continuous_are", a, b, q, r, e, s, balanced)


def solve_discrete_are(a, b, q, r, e=None, s=None, balanced=True):
  """Discrete algebraic Riccati equation on the host (Schur-based)."""
  return _riccati("solve_discrete_are", a, b, q, r, e, s, balanced)


def solve_toeplitz(c_or_cr, b, check_finite=True):
  """Toeplitz solve on the host (Levinson–Durbin, a sequential O(n²)
  recursion; the FFT route is for products, :func:`matmul_toeplitz`)."""
  del check_finite
  import scipy.linalg as sla
  c, r = _cr_pair(c_or_cr, "solve_toeplitz")
  _host_notice("solve_toeplitz")
  return HostExpr([c, r, sp.lazify(b)],
                  lambda cc, rr, bb: sla.solve_toeplitz((cc, rr), bb))


def expm_cond(A, check_finite=True):
  """Relative condition number of expm, an eager host scalar (scipy's
  Frechet-derivative norm estimate)."""
  del check_finite
  import scipy.linalg as sla
  return float(_host_eager("expm_cond", sla.expm_cond, _glommed(A)))


def _qr_mod(name, arrays, **kw):
  import scipy.linalg as sla
  return _host_eager(name, getattr(sla, name),
                     *[_glommed(a) for a in arrays], **kw)


def qr_update(Q, R, u, v, overwrite_qruv=False, check_finite=True):
  """Rank-1 QR update, an eager host utility (sequential Givens
  sweeps)."""
  del overwrite_qruv, check_finite
  return _qr_mod("qr_update", [Q, R, u, v])


def qr_insert(Q, R, u, k, which="row", rcond=None,
              overwrite_qru=False, check_finite=True):
  del overwrite_qru, check_finite
  return _qr_mod("qr_insert", [Q, R, u], k=int(k), which=which,
                 rcond=rcond)


def qr_delete(Q, R, k, p=1, which="row", overwrite_qr=False,
              check_finite=True):
  del overwrite_qr, check_finite
  return _qr_mod("qr_delete", [Q, R], k=int(k), p=int(p), which=which)


def qr_multiply(a, c, mode="right", pivoting=False, conjugate=False,
                overwrite_a=False, overwrite_c=False):
  del overwrite_a, overwrite_c
  return _qr_mod("qr_multiply", [a, c], mode=mode, pivoting=pivoting,
                 conjugate=conjugate)


__all__ += [
    "eigvalsh_tridiagonal", "diagsvd", "hadamard", "invpascal",
    "clarkson_woodruff_transform", "orthogonal_procrustes", "rq",
    "fractional_matrix_power", "matmul_toeplitz", "solve_circulant",
    "cdf2rdf", "qz", "ordqz", "cossin", "eig_banded", "eigvals_banded",
    "cholesky_banded", "cho_solve_banded", "solve_continuous_are",
    "solve_discrete_are", "solve_toeplitz", "expm_cond",
    "qr_update", "qr_insert", "qr_delete", "qr_multiply",
]
