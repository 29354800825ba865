"""``sp.linalg``: the ``numpy.linalg`` surface (port of
``spartan_tpu/linalg.py``).

Two kinds of entry point, as in the reference:

* the example programs promoted to a library: blocked ``cholesky``
  (``examples/cholesky.py``), CholeskyQR2 ``qr(method="tsqr")``
  (``examples/qr.py``), blocked ``solve_triangular``, ``lstsq`` by the
  normal equations, ``eigvalsh_lanczos`` (``examples/lanczos.py``, whose
  sparse matvec plans onto the SpMV kernels), ``svd_lowrank``
  (``examples/pca.py``'s SSVD) and ``cg`` (``examples/cg.py``);
* the dense factorizations, each a lazy map over one ``torch.linalg`` call
  on the mesh's device, where the reference maps ``jnp.linalg`` (XLA
  computes them with no Pallas kernel); the outputs of ``qr``, ``eigh``,
  ``svd`` and ``slogdet`` share one factorization, evaluated once.  They
  follow ``jnp.linalg``'s semantics where torch's differ: ``eigh``
  symmetrizes its input first; ``pinv``'s default cut-off is ``10 · max(m,
  n) · eps`` of the largest singular value; ``matrix_rank``'s default
  tolerance is ``max(m, n) · eps · s_max`` and a given ``rtol`` is an
  absolute tolerance, as in the reference; ``cond`` of a singular matrix
  is inf.  ``inv`` and ``solve`` use the ``_ex`` forms, which do not check
  on the host inside a map: a singular matrix gives inf/nan, the
  reference's values, and does not raise.  torch's least-squares solver is
  never called (its CUDA driver assumes full rank).

``eig`` and ``eigvals`` run on the host (``np.linalg.eig``), as the
reference's do, through a ``HostExpr`` (counted in
``expr.fio.counts["host_runs"]``), with a notice once a process.  The
reference's replication guard has nothing to guard here: dense arrays are
whole tensors on the one device, so no factorization gathers its operand.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch import util
from spartan_tpu_torch.backend.sparse import SparseArray
from spartan_tpu_torch.expr.base import Aval, Expr, ListExpr
from spartan_tpu_torch.expr.map import structural

__all__ = ["cholesky", "qr", "solve", "solve_triangular", "lstsq",
           "eigvalsh_lanczos", "svd_lowrank", "cg",
           "inv", "pinv", "det", "slogdet", "eigh", "eigvalsh", "eig",
           "eigvals", "svd", "svdvals", "matrix_power", "matrix_rank",
           "cond", "norm", "multi_dot", "tensorsolve", "tensorinv",
           "matrix_transpose"]


def cholesky(A, block: int = 128):
  """Lower-triangular ``L`` with ``L @ L.T == A`` for SPD ``A``: the
  blocked right-looking factor of ``examples/cholesky.py``."""
  from spartan_tpu_torch.examples import cholesky as _chol
  return _chol.factor(A, block=block)


def qr(X, method: str = "auto") -> Tuple[object, object]:
  """Reduced QR ``(Q, R)`` with ``Q @ R == X``.  Tall-skinny matrices (n ≥
  4d) take CholeskyQR2 (``'tsqr'``, two Gram-and-correct rounds),
  others Householder QR (``'householder'``, ``torch.linalg.qr``); either
  can be forced."""
  Xl = sp.lazify(X)
  n, d = Xl.shape
  if method == "auto":
    method = "tsqr" if n >= 4 * d else "householder"
  if method == "householder":
    return _lin_multi(Xl, _qr, 2)
  if method != "tsqr":
    raise ValueError(f"unknown qr method {method!r}")
  from spartan_tpu_torch.examples import qr as _qr_example
  q, r = _qr_example.tsqr(Xl)
  return q, sp.from_numpy(np.ascontiguousarray(r)).evaluate()


@structural
def _trsm(a, b, lower: bool):
  """``a x = b`` for triangular ``a`` (b a vector or a matrix)."""
  vec = b.ndim == 1
  x = torch.linalg.solve_triangular(a, b[:, None] if vec else b,
                                    upper=not lower)
  return x[:, 0] if vec else x


def solve_triangular(A, b, lower: bool = True, block: int = 256):
  """Solve ``A x = b`` for triangular ``A`` by blocked substitution: the
  O(n²) off-diagonal updates are contractions, each block × block diagonal
  system one ``torch.linalg.solve_triangular`` on the device (the
  reference solves it on the host).  ``b`` may be (n,) or (n, m)."""
  A, b = sp.lazify(A), sp.lazify(b)
  n = A.shape[0]
  vec = len(b.shape) == 1
  bounds = [(j, min(j + block, n)) for j in range(0, n, block)]
  if not lower:
    bounds = bounds[::-1]
  x = sp.Val(sp.zeros(tuple(b.shape), dtype=np.float64).evaluate())
  for i0, i1 in bounds:
    rhs = b[i0:i1]
    if lower and i0 > 0:
      rhs = rhs - sp.dot(A[i0:i1, 0:i0], x[0:i0], precision="highest")
    elif not lower and i1 < n:
      rhs = rhs - sp.dot(A[i0:i1, i1:n], x[i1:n], precision="highest")
    xi = sp.map([A[i0:i1, i0:i1], rhs], _trsm, fn_kw={"lower": lower})
    idx = (slice(i0, i1),) if vec else (slice(i0, i1), slice(None))
    x = sp.Val(sp.assign(x, idx, xi).evaluate())
  return x.evaluate()


def cg(A, b, tol: float = 1e-10, max_iters: int = 1000):
  """Conjugate-gradient SPD solve in one ``sp.while_loop`` iterating to
  tolerance (``examples/cg.solve_fused``)."""
  from spartan_tpu_torch.examples import cg as _cg
  return _cg.solve_fused(A, b, tol=tol, max_iters=max_iters)


@structural
def _solve2(a, b):
  return torch.linalg.solve_ex(a, b).result


def solve(A, b, method: str = "auto", block: int = 128,
          tol: float = 1e-10):
  """Solve ``A x = b``.  ``method``: ``'lu'`` (the default: partial-pivot
  LU on the device, any square ``A``), ``'cholesky'`` (SPD: the blocked
  factor, then two blocked triangular solves) or ``'cg'`` (SPD, iterative,
  one device loop)."""
  if method == "auto":
    method = "lu"
  if method == "lu":
    return sp.map([sp.lazify(A), sp.lazify(b)], _solve2)
  if method == "cg":
    return cg(A, b, tol=tol)
  if method != "cholesky":
    raise ValueError(f"unknown method {method!r}")
  L = cholesky(A, block=block)
  y = solve_triangular(L, b, lower=True, block=block)
  return solve_triangular(sp.transpose(L), y, lower=False, block=block)


def lstsq(X, y, reg: float = 0.0, method: str = "auto"):
  """``argmin_w |X w - y|² + reg |w|²`` by the normal equations: the
  (d, d) Gram matrix ``XᵀX`` and ``Xᵀy`` are contractions, then the SPD
  system is solved by :func:`solve` (``'cholesky'`` by default).  Returns
  the solution only."""
  X, y = sp.lazify(X), sp.lazify(y)
  d = X.shape[1]
  g = sp.dot(sp.transpose(X), X, precision="highest")
  if reg:
    g = g + reg * sp.eye(d, dtype=np.float64)
  c = sp.dot(sp.transpose(X), y, precision="highest")
  method = "cholesky" if method == "auto" else method
  return solve(sp.Val(g.evaluate()), sp.Val(c.evaluate()), method=method)


def eigvalsh_lanczos(A, k: int = 6, m: int = None, seed: int = 0):
  """Top-k eigenvalues of symmetric ``A`` from an m-step Lanczos subspace
  (the tridiagonal eigenproblem on the host); a (k,) numpy array,
  ascending."""
  from spartan_tpu_torch.examples import lanczos as _lan
  if not isinstance(A, SparseArray):
    A = sp.lazify(A)
  m = m if m is not None else max(2 * k + 8, 24)
  m = min(m, int(A.shape[0]))
  alphas, betas, _ = _lan.tridiagonalize(A, k=m, seed=seed)
  return _lan.ritz_values(alphas, betas)[-k:]


def svd_lowrank(X, k: int = 6, iterations: int = 20, seed: int = 0):
  """Randomized rank-k SVD (the reference's SSVD): ``(U (n, k), S (k,),
  Vt (k, d))`` numpy."""
  from spartan_tpu_torch.examples import pca as _pca
  return _pca.ssvd(X, k=k, iterations=iterations, seed=seed)


# -- the dense factorizations: lazy maps over torch.linalg -------------------

def _lin_map(fn, *args, **kw):
  return sp.map([sp.lazify(a) for a in args], fn, fn_kw=kw or None)


class _FactorExpr(Expr):
  """``fn(a, **kw)``, a factorization with several outputs, as one node
  whose value is the tuple of them.  :meth:`outputs` evaluates all of them
  in one region, once; each output the caller holds reads its own from
  there (:class:`_Output`), so ``A`` is factored once however the outputs
  are evaluated."""

  _members = ("inputs",)
  _params = ("fn", "kw")

  def __init__(self, a, fn, kw):
    super().__init__(inputs=[a], fn=fn, kw=tuple(sorted(kw.items())))
    self._outputs = None

  def _emit(self, ctx, deps):
    return tuple(self.fn(deps[0], **dict(self.kw)))

  def aval(self):
    if self._aval is None:
      a = self.inputs[0].aval().abstract_value()
      self._aval = tuple(Aval.of(t) for t in self._emit(None, [a]))
    return self._aval

  def outputs(self) -> list:
    if getattr(self, "_outputs", None) is None:
      self._outputs = ListExpr([_Item(self, i)
                                for i in range(len(self.aval()))]).evaluate()
    return self._outputs


class _Item(Expr):
  """Output ``i`` of a :class:`_FactorExpr`, inside the factor's region."""

  _members = ("inputs",)
  _params = ("i",)

  def __init__(self, factor: _FactorExpr, i: int):
    super().__init__(inputs=[factor], i=i)

  def _emit(self, ctx, deps):
    return deps[0][self.i]

  def aval(self):
    if self._aval is None:
      self._aval = self.inputs[0].aval()[self.i]
    return self._aval


class _Output(_Item):
  """Output ``i`` as the caller holds it: a region cut whose value is the
  factor's one evaluation of all its outputs."""

  _eager_boundary = True

  def evaluate_eager(self):
    return self.inputs[0].outputs()[self.i]


def _lin_multi(A, fn, n_out: int, **kw):
  """The ``n_out`` outputs of ``fn(A)`` as exprs over one factorization
  node, which factors ``A`` once for all of them."""
  factor = _FactorExpr(sp.lazify(A), fn, kw)
  return tuple(_Output(factor, i) for i in range(n_out))


def _qr(a):
  return torch.linalg.qr(a)


@structural
def _inv(a):
  return torch.linalg.inv_ex(a).inverse


@structural
def _pinv(a, rtol=None):
  """``jnp.linalg.pinv``: singular values at or below ``rtol · s_max``
  dropped (default ``rtol = 10 · max(m, n) · eps``)."""
  if not (a.is_floating_point() or a.is_complex()):
    a = a.to(torch.float64)
  m, n = a.shape[-2:]
  if rtol is None:
    rtol = 10.0 * max(m, n) * torch.finfo(a.dtype).eps
  u, s, vh = torch.linalg.svd(a, full_matrices=False)
  cutoff = rtol * s[..., :1]
  s = torch.where(s > cutoff, s, torch.inf).to(u.dtype)
  return vh.mH @ (u.mH / s[..., None])


@structural
def _det(a):
  return torch.linalg.det(a)


def _slogdet(a):
  return torch.linalg.slogdet(a)


def _sym(a):
  """The symmetrized input ``jnp.linalg.eigh`` factors."""
  return (a + a.mH) / 2


@structural
def _eigvalsh(a):
  return torch.linalg.eigvalsh(_sym(a))


def _eigh(a):
  return torch.linalg.eigh(_sym(a))


def _svd(a, full_matrices=False):
  return torch.linalg.svd(a, full_matrices=full_matrices)


@structural
def _svdvals(a):
  return torch.linalg.svdvals(a)


@structural
def _matrix_power(a, n: int):
  return torch.linalg.matrix_power(a, n)


@structural
def _matrix_rank(a, rtol=None):
  """``jnp.linalg.matrix_rank``: singular values above ``rtol`` (an
  absolute tolerance when given; ``max(m, n) · eps · s_max`` by default)."""
  if not (a.is_floating_point() or a.is_complex()):
    a = a.to(torch.float64)
  if a.ndim < 2:
    return (a != 0).any().to(torch.int32)
  s = torch.linalg.svdvals(a)
  if rtol is None:
    rtol = s.max(-1).values * max(a.shape[-2:]) * torch.finfo(s.dtype).eps
  return (s > torch.as_tensor(rtol, dtype=s.dtype, device=s.device)
          .unsqueeze(-1)).sum(-1)


@structural
def _cond(a, p=None):
  """``jnp.linalg.cond``: a ratio of singular values for p None, 2, -2;
  else ``norm(a, p) · norm(inv(a), p)``; nan from a singular matrix
  becomes inf."""
  if p is None or p == 2 or p == -2:
    s = torch.linalg.svdvals(a)
    r = s[..., 0] / s[..., -1] if p != -2 else s[..., -1] / s[..., 0]
    if p != -2:
      return r
  else:
    r = (torch.linalg.matrix_norm(a, ord=p)
         * torch.linalg.matrix_norm(torch.linalg.inv_ex(a).inverse, ord=p))
  return torch.where(torch.isnan(r) & ~torch.isnan(a).any((-2, -1)),
                     torch.inf, r)


@structural
def _norm(a, ord=None, axis=None, keepdims=False):
  return torch.linalg.norm(a, ord=ord, dim=axis, keepdim=keepdims)


@structural
def _tensorinv(a, ind: int):
  return torch.linalg.tensorinv(a, ind=ind)


@structural
def _tensorsolve(a, b, axes=None):
  return torch.linalg.tensorsolve(a, b, dims=axes)


@structural
def _multi_dot(*xs):
  return torch.linalg.multi_dot(list(xs))


def inv(A):
  """Matrix inverse by LU on the device; a singular matrix gives inf/nan
  and does not raise (prefer :func:`solve` for one system)."""
  return _lin_map(_inv, A)


def pinv(A, rtol=None):
  return _lin_map(_pinv, A, **({} if rtol is None else {"rtol": rtol}))


def det(A):
  return _lin_map(_det, A)


def slogdet(A):
  """``(sign, logabsdet)`` exprs (``np.linalg.slogdet``'s contract)."""
  return _lin_multi(A, _slogdet, 2)


def eigvalsh(A):
  """The full ascending spectrum of a symmetric matrix on the device (for
  the top k at scale, :func:`eigvalsh_lanczos`)."""
  return _lin_map(_eigvalsh, A)


def eigh(A):
  """``(w, v)`` exprs: eigenvalues ascending, orthonormal columns."""
  return _lin_multi(A, _eigh, 2)


def _eig_stacked(a):
  w, v = np.linalg.eig(a)
  return np.concatenate([w[None, :], v], axis=0)


def _eig_host_notice(name):
  """Say once a process that eig/eigvals run on the host."""
  if _eig_host_notice.done:
    return
  _eig_host_notice.done = True
  util.log_info(
      "sp.linalg.%s: the general (non-symmetric) eigendecomposition "
      "evaluates EAGERLY on the host (np.linalg.%s), breaking the lazy "
      "chain at this node, as in the reference; for symmetric or "
      "Hermitian operands sp.linalg.eigh runs on the device.", name, name)


_eig_host_notice.done = False


def eig(A):
  """General eigendecomposition ``(w, v)`` on the host, one factorization
  for both (slices of one stacked result); complex outputs."""
  from spartan_tpu_torch.expr.fio import HostExpr
  _eig_host_notice("eig")
  st = HostExpr([sp.lazify(A)], _eig_stacked)
  return st[0], st[1:]


def eigvals(A):
  from spartan_tpu_torch.expr.fio import HostExpr
  _eig_host_notice("eigvals")
  return HostExpr([sp.lazify(A)], np.linalg.eigvals)


def svd(X, full_matrices: bool = False, compute_uv: bool = True):
  """The full SVD ``(U, S, Vt)`` as exprs on the device; with
  ``compute_uv=False`` the singular values alone.  For rank k at scale,
  :func:`svd_lowrank`."""
  if not compute_uv:
    return _lin_map(_svdvals, X)
  return _lin_multi(X, _svd, 3, full_matrices=full_matrices)


def svdvals(X):
  return svd(X, compute_uv=False)


def matrix_power(A, n: int):
  return _lin_map(_matrix_power, A, n=int(n))


def matrix_rank(A, rtol=None):
  return _lin_map(_matrix_rank, A, **({} if rtol is None else {"rtol": rtol}))


def cond(A, p=None):
  return _lin_map(_cond, A, **({} if p is None else {"p": p}))


def multi_dot(arrays):
  """A chain of matmuls in the best order (``np.linalg.multi_dot``), one
  region over all operands."""
  return sp.map([sp.lazify(a) for a in arrays], _multi_dot)


def tensorsolve(A, b, axes=None):
  return _lin_map(_tensorsolve, A, b,
                  **({} if axes is None else {"axes": tuple(axes)}))


def tensorinv(A, ind: int = 2):
  return _lin_map(_tensorinv, A, ind=int(ind))


def matrix_transpose(A):
  return sp.swapaxes(sp.lazify(A), -1, -2)


def norm(x, ord=None, axis=None, keepdims: bool = False):
  """``np.linalg.norm`` with its whole ``ord`` surface (a matrix's 2-norm
  is its largest singular value; ``sp.norm`` is the flat norm)."""
  kw = {"keepdims": keepdims}
  if ord is not None:
    kw["ord"] = ord
  if axis is not None:
    kw["axis"] = tuple(axis) if isinstance(axis, (list, tuple)) else axis
  return _lin_map(_norm, x, **kw)


# -- NumPy 2.0's array-API additions to np.linalg -------------------------

def matmul(a, b):
  return sp.matmul(a, b)


def tensordot(a, b, axes=2):
  return sp.tensordot(a, b, axes=axes)


def outer(a, b):
  return sp.outer(a, b)


def cross(a, b, axis=-1):
  return sp.cross(a, b, axis=axis)


def diagonal(A, offset=0):
  return sp.diagonal(sp.lazify(A), offset=offset)


def trace(A, offset=0):
  return sp.trace(sp.lazify(A), offset=offset)


def vecdot(a, b, axis=-1):
  return sp.vecdot(a, b, axis=axis)


def matrix_norm(A, ord="fro", keepdims: bool = False):
  return norm(sp.lazify(A), ord=ord, axis=(-2, -1), keepdims=keepdims)


def vector_norm(x, ord=2, axis=None, keepdims: bool = False):
  v = sp.lazify(x)
  if axis is None and v.ndim > 1:
    out = norm(sp.ravel(v), ord=ord)
    # NumPy's keepdims: all-singleton shape at the original rank
    return sp.reshape(out, (1,) * v.ndim) if keepdims else out
  return norm(v, ord=ord, axis=axis, keepdims=keepdims)


__all__ += ["matmul", "tensordot", "outer", "cross", "diagonal", "trace",
            "vecdot", "matrix_norm", "vector_norm"]
