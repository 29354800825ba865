"""``sp.stats`` — the scipy.stats surface (port of ``spartan_tpu/stats.py``).

Three layers, as in the reference:

* **device distributions** — the 24 workhorse distributions
  (norm/t/chi2/gamma/beta/f/expon/uniform/lognorm/laplace/logistic/
  cauchy/gumbel/pareto/weibull_min/rayleigh/halfnorm/truncnorm +
  poisson/binom/nbinom/geom/bernoulli) are declarative specs over the
  standardized variable: a logpdf, cdf and ppf in torch ops (the ppfs on
  ``sp.special``'s fixed-count bisection inverses), closed-form mean/var/
  entropy, and generic loc/scale handling.  Every method returns a lazy
  elementwise Expr that fuses with the expressions around it; ``rvs`` is
  inverse-CDF sampling through the device ppf of ``sp.random``'s uniform
  draws.  Frozen (``norm(1, 2).pdf(x)``) and direct (``norm.pdf(x, 1, 2)``)
  calling conventions both work, as in scipy.
* **descriptive statistics and tests** — lazy maps that reduce along an
  axis, sort or concatenate their operands, so each is a
  ``map.structural`` function: its inputs stay whole, never folded or
  split by the elementwise passes.  The tests compute the statistic on the
  device and the p-value through the betainc/gammainc/ndtr/kolmogorov
  identities, and return scipy's result tuples.  ``mode`` and ``rankdata``
  run over the port's stable sort (``expr.sort_expr``), percentiles and
  medians over its ``quantiles``.
* **host boundary** — every other callable of ``scipy.stats`` is wrapped:
  its operands are brought to the host through ``glom`` and the call is
  counted in ``expr.fio.counts["host_runs"]``.  Classes and the exotic
  distribution objects are scipy's own.  ``_HOST_NAMES`` lists them.

Integer and bool operands become float64 (scipy's promotion); float32
stays float32.
"""

from __future__ import annotations

import collections
import functools
import inspect as _inspect
import math

import numpy as np
import scipy.stats as _sst
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr import sort_expr as _sort
from spartan_tpu_torch.expr.builtins import _searchsorted
from spartan_tpu_torch.expr.map import structural
from spartan_tpu_torch.special import (_bcast, _betainc, _betaincinv_kern,
                                       _betaln, _entr, _f, _gammainc,
                                       _gammaincc, _gammainccinv_kern,
                                       _gammaincinv_kern, _host_value,
                                       _kolmogorov_kern, _lifted, _mapn,
                                       _mapn_whole, _ndtr, _rel_entr)
from spartan_tpu_torch.util import log_info

_py_callable = callable
_EULER = float(np.euler_gamma)
_PI = math.pi
_LN2 = math.log(2.0)
_LOG_SQRT_2PI = float(0.5 * np.log(2 * np.pi))

_ndtri = torch.special.ndtri
_gammaln = torch.special.gammaln
_xlogy = torch.special.xlogy
_xlog1py = torch.special.xlog1py


def _pick(kern, i, *aa):
  return kern(*aa)[i]


def _map_multi(kern, nout, *args):
  """A kernel with ``nout`` outputs -> one lazy structural Expr an output
  (each map selects [i] of the kernel's tuple)."""
  ops = [sp.lazify(a) for a in args]
  return tuple(sp.map(ops, structural(_lifted(functools.partial(
      _pick, kern, i)))) for i in range(nout))


# -- axis helpers (NumPy's reductions on torch tensors) --------------------

def _dims(x, axis):
  return tuple(range(x.ndim)) if axis is None else (axis,)


def _count(x, axis) -> int:
  return x.numel() if axis is None else x.shape[axis]


def _mean(x, axis, keepdims=False):
  return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


def _sum(x, axis, keepdims=False):
  return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims)


def _var(x, axis, ddof=0, keepdims=False):
  return torch.var(x, dim=_dims(x, axis), correction=ddof, keepdim=keepdims)


def _std(x, axis, ddof=0, keepdims=False):
  return torch.sqrt(_var(x, axis, ddof, keepdims))


def _expand(v, x, axis):
  """``v`` reduced from ``x`` along ``axis`` with the axis kept (size 1)."""
  if axis is None:
    return v.reshape((1,) * x.ndim)
  return v.unsqueeze(axis % x.ndim)


def _percentiles(x, qs, axis, method="linear"):
  """NumPy's ``percentile(x, qs, axis, method)`` for the methods ``linear``
  (``sort_expr.quantiles``), ``lower``, ``higher``, ``nearest`` and
  ``midpoint``: shape ``(len(qs),) + kept axes``."""
  fr = tuple(float(q) / 100.0 for q in qs)
  if method == "linear":
    return _sort.quantiles(x, fr, axis)
  if method not in ("lower", "higher", "nearest", "midpoint"):
    raise ValueError(f"unknown interpolation method {method!r}")
  s = _sort.sort(_sort._to_last(x, axis))
  m = s.shape[-1]
  pos = torch.tensor(fr, dtype=torch.float64, device=x.device) * (m - 1)
  lo, hi = torch.floor(pos), torch.ceil(pos)
  if method == "nearest":
    lo = hi = torch.round(pos)
  take = [torch.index_select(s, -1, i.to(torch.int64)) for i in (lo, hi)]
  out = take[0] if method in ("lower", "nearest") else take[1]
  if method == "midpoint":
    out = (take[0] + take[1]) / 2
  out = torch.where(torch.isnan(s[..., -1:]), math.nan, out)
  return out.movedim(-1, 0)


def _median(x, axis, keepdims=False):
  med = _sort.quantiles(x, 0.5, axis)
  return _expand(med, x, axis) if keepdims else med


# ---------------------------------------------------------------------
# device distribution framework
# ---------------------------------------------------------------------

def _int_ppf(cdf_k, q, hi):
  """Smallest integer k with cdf(k) >= q — 64-step integer bisection
  (a fixed count: no host read; invariant cdf(lo) < q <= cdf(hi))."""
  q, hi = torch.broadcast_tensors(q, hi.to(q.dtype) if isinstance(
      hi, torch.Tensor) else torch.tensor(hi, dtype=q.dtype, device=q.device))
  lo = torch.full_like(q, -1.0)
  hi = hi.clone()
  for _ in range(64):
    mid = torch.floor((lo + hi) / 2)
    ge = cdf_k(mid) >= q
    lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
  return hi


class _Frozen:
  """Frozen distribution: shape/loc/scale bound at construction."""

  def __init__(self, dist, args, kwds):
    self._dist, self._args, self._kwds = dist, args, kwds

  def __getattr__(self, name):
    meth = getattr(self._dist, name)

    def call(*a, **k):
      return meth(*a, *self._args, **{**self._kwds, **k})
    return call


class _DeviceDist:
  """Declarative device distribution (continuous or discrete).

  Hooks operate on the STANDARDIZED variable as torch tensors; loc/scale
  handling, derived methods (sf/isf/log*/median/std/interval/rvs) and the
  frozen-call convention are generic."""

  def __init__(self, name, nshape, logpdf, cdf, ppf, mean, var,
               entropy=None, support=(-np.inf, np.inf), discrete=False,
               sf=None, isf=None):
    self.name = name
    self._ns = nshape
    self._logpdf, self._cdf, self._ppf = logpdf, cdf, ppf
    self._mean_fn, self._var_fn, self._entropy_fn = mean, var, entropy
    self._support = support
    self._discrete = discrete
    self._sf, self._isf = sf, isf
    self.__doc__ = (f"Device {name} distribution (lazy Exprs; "
                    "scipy.stats calling conventions)")

  def __call__(self, *args, **kwds):
    return _Frozen(self, args, kwds)

  def _split(self, args, kwds):
    shp = list(args[:self._ns])
    rest = list(args[self._ns:])
    for i in range(len(shp), self._ns):
      shp.append(kwds.pop(f"arg{i}"))
    loc = kwds.pop("loc", rest[0] if rest else 0.0)
    if rest:
      rest = rest[1:]
    scale = kwds.pop("scale", rest[0] if rest else 1.0)
    if kwds:
      raise TypeError(f"{self.name}: unexpected kwargs {list(kwds)}")
    return shp, loc, scale

  # -- core methods ---------------------------------------------------

  def logpdf(self, x, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)

    def kern(xx, ll, ss, *sh):
      z = (_f(xx) - _f(ll)) / _f(ss)
      out = self._logpdf(z, *[_f(s) for s in sh]) - torch.log(_f(ss))
      lob, hib = self._support
      ok = (z >= lob) & (z <= hib)
      return torch.where(ok, out, -math.inf)
    return _mapn(kern, x, loc, scale, *shp)

  def pdf(self, x, *args, **kwds):
    return sp.exp(self.logpdf(x, *args, **kwds))

  def logpmf(self, k, *args, **kwds):
    if not self._discrete:
      raise AttributeError(f"{self.name} is continuous")
    return self.logpdf(k, *args, **kwds)

  def pmf(self, k, *args, **kwds):
    if not self._discrete:
      raise AttributeError(f"{self.name} is continuous")
    return sp.exp(self.logpdf(k, *args, **kwds))

  def cdf(self, x, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)

    def kern(xx, ll, ss, *sh):
      z = (_f(xx) - _f(ll)) / _f(ss)
      if self._discrete:
        z = torch.floor(z)
      out = self._cdf(z, *[_f(s) for s in sh])
      lob, hib = self._support
      return torch.clip(torch.where(z < lob, 0.0,
                                    torch.where(z > hib, 1.0, out)), 0.0, 1.0)
    return _mapn(kern, x, loc, scale, *shp)

  def sf(self, x, *args, **kwds):
    if self._sf is not None:
      shp, loc, scale = self._split(args, kwds)

      def kern(xx, ll, ss, *sh):
        z = (_f(xx) - _f(ll)) / _f(ss)
        if self._discrete:
          z = torch.floor(z)
        out = self._sf(z, *[_f(s) for s in sh])
        lob, hib = self._support
        return torch.clip(torch.where(z < lob, 1.0,
                                      torch.where(z > hib, 0.0, out)),
                          0.0, 1.0)
      return _mapn(kern, x, loc, scale, *shp)
    return 1.0 - self.cdf(x, *args, **kwds)

  def logcdf(self, x, *args, **kwds):
    return sp.log(self.cdf(x, *args, **kwds))

  def logsf(self, x, *args, **kwds):
    return sp.log(self.sf(x, *args, **kwds))

  def ppf(self, q, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)

    def kern(qq, ll, ss, *sh):
      qq = _f(qq)
      z = self._ppf(qq, *[_f(s) for s in sh])
      out = _f(ll) + _f(ss) * z
      return torch.where((qq < 0) | (qq > 1), math.nan, out)
    return _mapn(kern, q, loc, scale, *shp)

  def isf(self, q, *args, **kwds):
    if self._isf is not None:
      shp, loc, scale = self._split(args, kwds)

      def kern(qq, ll, ss, *sh):
        qq = _f(qq)
        z = self._isf(qq, *[_f(s) for s in sh])
        out = _f(ll) + _f(ss) * z
        return torch.where((qq < 0) | (qq > 1), math.nan, out)
      return _mapn(kern, q, loc, scale, *shp)
    return self.ppf(1.0 - sp.lazify(q), *args, **kwds)

  # -- moments / summaries --------------------------------------------

  def mean(self, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)
    return _mapn(lambda ll, ss, *sh:
                 _f(ll) + _f(ss) * self._mean_fn(*[_f(s) for s in sh]),
                 loc, scale, *shp)

  def var(self, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)
    return _mapn(lambda ll, ss, *sh:
                 _f(ss) ** 2 * self._var_fn(*[_f(s) for s in sh]),
                 loc, scale, *shp)

  def std(self, *args, **kwds):
    return sp.sqrt(self.var(*args, **kwds))

  def median(self, *args, **kwds):
    return self.ppf(0.5, *args, **kwds)

  def entropy(self, *args, **kwds):
    if self._entropy_fn is None:
      return _host_call_dist(self.name, "entropy", args, kwds)
    shp, loc, scale = self._split(args, kwds)
    if self._discrete:
      return _mapn(lambda ll, ss, *sh:
                   self._entropy_fn(*[_f(s) for s in sh]),
                   loc, scale, *shp)
    return _mapn(lambda ll, ss, *sh:
                 self._entropy_fn(*[_f(s) for s in sh])
                 + torch.log(_f(ss)), loc, scale, *shp)

  def stats(self, *args, **kwds):
    moments = kwds.pop("moments", "mv")
    out = []
    for m in moments:
      if m == "m":
        out.append(self.mean(*args, **kwds))
      elif m == "v":
        out.append(self.var(*args, **kwds))
      else:   # skew/kurtosis: host closed forms via scipy
        out.append(_host_call_dist(self.name, "stats", args,
                                   {**kwds, "moments": m}))
    return tuple(out)

  def interval(self, confidence, *args, **kwds):
    alpha = (1.0 - sp.lazify(confidence)) / 2.0
    return (self.ppf(alpha, *args, **kwds),
            self.isf(alpha, *args, **kwds))

  def support(self, *args, **kwds):
    shp, loc, scale = self._split(args, kwds)
    lob, hib = self._support
    lo = sp.lazify(loc) + sp.lazify(scale) * lob if np.isfinite(lob) \
        else sp.lazify(np.float64(lob))
    hi = sp.lazify(loc) + sp.lazify(scale) * hib if np.isfinite(hib) \
        else sp.lazify(np.float64(hib))
    return lo, hi

  def moment(self, order, *args, **kwds):
    return _host_call_dist(self.name, "moment", (order,) + args, kwds)

  def fit(self, data, *args, **kwds):
    return _host_call_dist(self.name, "fit", (data,) + args, kwds)

  def rvs(self, *args, size=None, random_state=None, **kwds):
    """Inverse-CDF sampling through the device ppf of ``sp.random``'s
    uniform draws, seeded by an int ``random_state`` (torch's generator:
    the draws follow the distribution, not the reference's jax stream)."""
    shp, loc, scale = self._split(args, kwds)
    if size is None:
      size = ()
    if np.isscalar(size):
      size = (int(size),)
    seed = random_state if isinstance(random_state, (int, np.integer)) \
        else np.random.SeedSequence().entropy % (2 ** 31)
    u = sp.random.Generator(int(seed)).random(tuple(size))

    def kern(uu, ll, ss, *sh):
      z = self._ppf(_f(uu), *[_f(s) for s in sh])
      out = _f(ll) + _f(ss) * z
      return torch.floor(out) if self._discrete else out
    return _mapn(kern, u, loc, scale, *shp)


def _host_call_dist(name, meth, args, kwds):
  _host_notice(f"{name}.{meth}")
  fio.counts["host_runs"] += 1
  return getattr(getattr(_sst, name), meth)(
      *[_host_value(a) for a in args], **kwds)


# -- standardized hooks (z is the standardized variable) ---------------

def _t_cdf(z, df):
  ib = _betainc(df / 2, torch.full_like(df, 0.5), df / (df + z * z))
  return torch.where(z >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def _t_ppf(q, df):
  qq = 2.0 * torch.minimum(q, 1.0 - q)
  xb = _betaincinv_kern(df / 2, torch.full_like(df, 0.5), qq)
  tt = torch.sqrt(df * (1.0 - xb) / torch.clamp_min(xb, 1e-300))
  return torch.where(q >= 0.5, tt, -tt)


def _softplus(x):
  return torch.logaddexp(x, torch.zeros_like(x))


norm = _DeviceDist(
    "norm", 0,
    logpdf=lambda z: -0.5 * z * z - _LOG_SQRT_2PI,
    cdf=lambda z: _ndtr(z),
    ppf=lambda q: _ndtri(q),
    mean=lambda: 0.0, var=lambda: 1.0,
    entropy=lambda: 0.5 * np.log(2 * np.pi * np.e),
    sf=lambda z: _ndtr(-z), isf=lambda q: -_ndtri(q))

t = _DeviceDist(
    "t", 1,
    logpdf=lambda z, df: (_gammaln((df + 1) / 2) - _gammaln(df / 2)
                          - 0.5 * torch.log(df * np.pi)
                          - (df + 1) / 2 * torch.log1p(z * z / df)),
    cdf=_t_cdf,
    ppf=_t_ppf,
    mean=lambda df: torch.where(df > 1, torch.zeros_like(df), math.nan),
    var=lambda df: torch.where(df > 2, df / (df - 2),
                               torch.where(df > 1, math.inf,
                                           torch.full_like(df, math.nan))))

chi2 = _DeviceDist(
    "chi2", 1,
    logpdf=lambda z, df: ((df / 2 - 1) * torch.log(z) - z / 2
                          - _gammaln(df / 2) - (df / 2) * _LN2),
    cdf=lambda z, df: _gammainc(df / 2, z / 2),
    sf=lambda z, df: _gammaincc(df / 2, z / 2),
    ppf=lambda q, df: 2.0 * _gammaincinv_kern(df / 2, q),
    isf=lambda q, df: 2.0 * _gammainccinv_kern(df / 2, q),
    mean=lambda df: df, var=lambda df: 2.0 * df,
    support=(0.0, np.inf))

gamma = _DeviceDist(
    "gamma", 1,
    logpdf=lambda z, a: ((a - 1) * torch.log(z) - z - _gammaln(a)),
    cdf=lambda z, a: _gammainc(a, z),
    sf=lambda z, a: _gammaincc(a, z),
    ppf=lambda q, a: _gammaincinv_kern(a, q),
    isf=lambda q, a: _gammainccinv_kern(a, q),
    mean=lambda a: a, var=lambda a: a,
    entropy=lambda a: a + _gammaln(a) + (1 - a) * torch.special.digamma(a),
    support=(0.0, np.inf))

beta = _DeviceDist(
    "beta", 2,
    logpdf=lambda z, a, b: ((a - 1) * torch.log(z)
                            + (b - 1) * torch.log1p(-z)
                            - _betaln(a, b)),
    cdf=lambda z, a, b: _betainc(a, b, z),
    ppf=lambda q, a, b: _betaincinv_kern(a, b, q),
    mean=lambda a, b: a / (a + b),
    var=lambda a, b: a * b / ((a + b) ** 2 * (a + b + 1)),
    support=(0.0, 1.0))


def _f_ppf(q, dfn, dfd):
  dfn, dfd, q = _bcast(dfn, dfd, q)
  w = _betaincinv_kern(dfn / 2, dfd / 2, q)
  return dfd * w / (dfn * torch.clamp_min(1.0 - w, 1e-300))


f = _DeviceDist(
    "f", 2,
    logpdf=lambda z, dfn, dfd: (
        dfn / 2 * torch.log(dfn) + dfd / 2 * torch.log(dfd)
        + (dfn / 2 - 1) * torch.log(z)
        - (dfn + dfd) / 2 * torch.log(dfd + dfn * z)
        - _betaln(dfn / 2, dfd / 2)),
    cdf=lambda z, dfn, dfd: _betainc(dfn / 2, dfd / 2,
                                     dfn * z / (dfn * z + dfd)),
    sf=lambda z, dfn, dfd: _betainc(dfd / 2, dfn / 2,
                                    dfd / (dfd + dfn * z)),
    ppf=_f_ppf,
    mean=lambda dfn, dfd: torch.where(dfd > 2, dfd / (dfd - 2), math.nan),
    var=lambda dfn, dfd: torch.where(
        dfd > 4, 2 * dfd ** 2 * (dfn + dfd - 2)
        / (dfn * (dfd - 2) ** 2 * (dfd - 4)), math.nan),
    support=(0.0, np.inf))

expon = _DeviceDist(
    "expon", 0,
    logpdf=lambda z: -z,
    cdf=lambda z: -torch.expm1(-z),
    sf=lambda z: torch.exp(-z),
    ppf=lambda q: -torch.log1p(-q),
    isf=lambda q: -torch.log(q),
    mean=lambda: 1.0, var=lambda: 1.0, entropy=lambda: 1.0,
    support=(0.0, np.inf))

uniform = _DeviceDist(
    "uniform", 0,
    logpdf=lambda z: torch.zeros_like(z),
    cdf=lambda z: z,
    ppf=lambda q: q,
    mean=lambda: 0.5, var=lambda: 1.0 / 12, entropy=lambda: 0.0,
    support=(0.0, 1.0))

laplace = _DeviceDist(
    "laplace", 0,
    logpdf=lambda z: -torch.abs(z) - _LN2,
    cdf=lambda z: torch.where(z >= 0, 1.0 - 0.5 * torch.exp(-z),
                              0.5 * torch.exp(z)),
    ppf=lambda q: torch.where(q >= 0.5, -torch.log(2 * (1 - q)),
                              torch.log(2 * q)),
    mean=lambda: 0.0, var=lambda: 2.0,
    entropy=lambda: 1.0 + _LN2)

logistic = _DeviceDist(
    "logistic", 0,
    logpdf=lambda z: -z - 2 * _softplus(-z),
    cdf=lambda z: torch.special.expit(z),
    sf=lambda z: torch.special.expit(-z),
    ppf=lambda q: torch.special.logit(q),
    isf=lambda q: -torch.special.logit(q),
    mean=lambda: 0.0, var=lambda: np.pi ** 2 / 3, entropy=lambda: 2.0)

cauchy = _DeviceDist(
    "cauchy", 0,
    logpdf=lambda z: -math.log(np.pi) - torch.log1p(z * z),
    cdf=lambda z: 0.5 + torch.arctan(z) / np.pi,
    ppf=lambda q: torch.tan(np.pi * (q - 0.5)),
    mean=lambda: math.nan, var=lambda: math.nan,
    entropy=lambda: np.log(4 * np.pi))

lognorm = _DeviceDist(
    "lognorm", 1,
    logpdf=lambda z, s: (-torch.log(z) - torch.log(s) - _LOG_SQRT_2PI
                         - torch.log(z) ** 2 / (2 * s * s)),
    cdf=lambda z, s: _ndtr(torch.log(z) / s),
    sf=lambda z, s: _ndtr(-torch.log(z) / s),
    ppf=lambda q, s: torch.exp(s * _ndtri(q)),
    mean=lambda s: torch.exp(s * s / 2),
    var=lambda s: (torch.exp(s * s) - 1) * torch.exp(s * s),
    support=(0.0, np.inf))

gumbel_r = _DeviceDist(
    "gumbel_r", 0,
    logpdf=lambda z: -z - torch.exp(-z),
    cdf=lambda z: torch.exp(-torch.exp(-z)),
    ppf=lambda q: -torch.log(-torch.log(q)),
    mean=lambda: _EULER, var=lambda: np.pi ** 2 / 6,
    entropy=lambda: _EULER + 1.0)

gumbel_l = _DeviceDist(
    "gumbel_l", 0,
    logpdf=lambda z: z - torch.exp(z),
    cdf=lambda z: -torch.expm1(-torch.exp(z)),
    sf=lambda z: torch.exp(-torch.exp(z)),
    ppf=lambda q: torch.log(-torch.log1p(-q)),
    mean=lambda: -_EULER, var=lambda: np.pi ** 2 / 6,
    entropy=lambda: _EULER + 1.0)

pareto = _DeviceDist(
    "pareto", 1,
    logpdf=lambda z, b: torch.log(b) - (b + 1) * torch.log(z),
    cdf=lambda z, b: 1.0 - z ** -b,
    sf=lambda z, b: z ** -b,
    ppf=lambda q, b: (1.0 - q) ** (-1.0 / b),
    isf=lambda q, b: q ** (-1.0 / b),
    mean=lambda b: torch.where(b > 1, b / (b - 1), math.inf),
    var=lambda b: torch.where(b > 2, b / ((b - 1) ** 2 * (b - 2)), math.inf),
    support=(1.0, np.inf))

weibull_min = _DeviceDist(
    "weibull_min", 1,
    logpdf=lambda z, c: (torch.log(c) + (c - 1) * torch.log(z) - z ** c),
    cdf=lambda z, c: -torch.expm1(-z ** c),
    sf=lambda z, c: torch.exp(-z ** c),
    ppf=lambda q, c: (-torch.log1p(-q)) ** (1.0 / c),
    mean=lambda c: torch.exp(_gammaln(1 + 1 / c)),
    var=lambda c: (torch.exp(_gammaln(1 + 2 / c))
                   - torch.exp(2 * _gammaln(1 + 1 / c))),
    support=(0.0, np.inf))

rayleigh = _DeviceDist(
    "rayleigh", 0,
    logpdf=lambda z: torch.log(z) - z * z / 2,
    cdf=lambda z: -torch.expm1(-z * z / 2),
    sf=lambda z: torch.exp(-z * z / 2),
    ppf=lambda q: torch.sqrt(-2 * torch.log1p(-q)),
    mean=lambda: np.sqrt(np.pi / 2), var=lambda: 2 - np.pi / 2,
    support=(0.0, np.inf))

halfnorm = _DeviceDist(
    "halfnorm", 0,
    logpdf=lambda z: -z * z / 2 - _LOG_SQRT_2PI + _LN2,
    cdf=lambda z: 2 * _ndtr(z) - 1,
    ppf=lambda q: _ndtri((q + 1) / 2),
    mean=lambda: np.sqrt(2 / np.pi), var=lambda: 1 - 2 / np.pi,
    support=(0.0, np.inf))


def _phi(z):
  return torch.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)


def _tn_mean(a, b):
  Z = _ndtr(b) - _ndtr(a)
  return (_phi(a) - _phi(b)) / Z


def _tn_var(a, b):
  Z = _ndtr(b) - _ndtr(a)
  m = (_phi(a) - _phi(b)) / Z
  return 1.0 + (a * _phi(a) - b * _phi(b)) / Z - m * m


def _tn_cdf(z, a, b):
  z, a, b = _bcast(z, a, b)
  return ((_ndtr(torch.clip(z, a, b)) - _ndtr(a)) / (_ndtr(b) - _ndtr(a)))


truncnorm = _DeviceDist(
    "truncnorm", 2,
    logpdf=lambda z, a, b: (-0.5 * z * z - _LOG_SQRT_2PI
                            - torch.log(_ndtr(b) - _ndtr(a))),
    cdf=_tn_cdf,
    ppf=lambda q, a, b: _ndtri(_ndtr(a) + q * (_ndtr(b) - _ndtr(a))),
    mean=_tn_mean,
    var=_tn_var)


# -- discrete ----------------------------------------------------------

def _binom_cdf(k, n, p):
  k = torch.floor(k)
  out = _betainc(torch.clamp_min(n - k, 1e-30), k + 1, 1.0 - p)
  return torch.where(k >= n, 1.0, torch.where(k < 0, 0.0, out))


poisson = _DeviceDist(
    "poisson", 1, discrete=True,
    logpdf=lambda k, mu: (k * torch.log(mu) - mu - _gammaln(k + 1)),
    cdf=lambda k, mu: _gammaincc(torch.floor(k) + 1, mu),
    ppf=lambda q, mu: _int_ppf(
        lambda kk: _gammaincc(kk + 1, mu), q,
        mu + 60 * torch.sqrt(mu) + 60),
    mean=lambda mu: mu, var=lambda mu: mu,
    support=(0.0, np.inf))

binom = _DeviceDist(
    "binom", 2, discrete=True,
    logpdf=lambda k, n, p: (_gammaln(n + 1) - _gammaln(k + 1)
                            - _gammaln(n - k + 1)
                            + _xlogy(k, p) + _xlog1py(n - k, -p)),
    cdf=_binom_cdf,
    ppf=lambda q, n, p: _int_ppf(lambda kk: _binom_cdf(kk, n, p), q, n),
    mean=lambda n, p: n * p, var=lambda n, p: n * p * (1 - p),
    support=(0.0, np.inf))

nbinom = _DeviceDist(
    "nbinom", 2, discrete=True,
    logpdf=lambda k, n, p: (_gammaln(k + n) - _gammaln(k + 1)
                            - _gammaln(n) + n * torch.log(p)
                            + _xlog1py(k, -p)),
    cdf=lambda k, n, p: _betainc(n, torch.floor(k) + 1, p),
    ppf=lambda q, n, p: _int_ppf(
        lambda kk: _betainc(n, kk + 1, p), q,
        60 + 60 * n * (1 - p) / torch.clamp_min(p * p, 1e-12)),
    mean=lambda n, p: n * (1 - p) / p,
    var=lambda n, p: n * (1 - p) / (p * p),
    support=(0.0, np.inf))

geom = _DeviceDist(
    "geom", 1, discrete=True,
    logpdf=lambda k, p: _xlog1py(k - 1, -p) + torch.log(p),
    cdf=lambda k, p: -torch.expm1(_xlog1py(torch.floor(k), -p)),
    sf=lambda k, p: torch.exp(_xlog1py(torch.floor(k), -p)),
    ppf=lambda q, p: torch.ceil(torch.log1p(-q) / torch.log1p(-p)),
    mean=lambda p: 1.0 / p, var=lambda p: (1 - p) / (p * p),
    support=(1.0, np.inf))

bernoulli = _DeviceDist(
    "bernoulli", 1, discrete=True,
    logpdf=lambda k, p: _xlogy(k, p) + _xlog1py(1 - k, -p),
    cdf=lambda k, p: torch.where(torch.floor(k) >= 1, 1.0,
                                 torch.where(k < 0, 0.0, 1.0 - p)),
    ppf=lambda q, p: torch.where(q > 1.0 - p, 1.0, torch.zeros_like(q)),
    mean=lambda p: p, var=lambda p: p * (1 - p),
    entropy=lambda p: -(_xlogy(p, p) + _xlog1py(1 - p, -p)),
    support=(0.0, 1.0))

_DEVICE_DISTS = {
    "norm": norm, "t": t, "chi2": chi2, "gamma": gamma, "beta": beta,
    "f": f, "expon": expon, "uniform": uniform, "laplace": laplace,
    "logistic": logistic, "cauchy": cauchy, "lognorm": lognorm,
    "gumbel_r": gumbel_r, "gumbel_l": gumbel_l, "pareto": pareto,
    "weibull_min": weibull_min, "rayleigh": rayleigh,
    "halfnorm": halfnorm, "truncnorm": truncnorm, "poisson": poisson,
    "binom": binom, "nbinom": nbinom, "geom": geom,
    "bernoulli": bernoulli,
}

# ---------------------------------------------------------------------
# descriptive statistics (lazy structural maps: each reduces, sorts or
# concatenates along an axis)
# ---------------------------------------------------------------------


def _weighted(a, weights, kern):
  ops = [a] + ([weights] if weights is not None else [])
  return _mapn_whole(kern, *ops)


def gmean(a, axis=0, dtype=None, weights=None):
  """Geometric mean — exp of the (optionally weighted) mean log."""
  def kern(aa, *ww):
    la = torch.log(_f(aa))
    if ww:
      w = _f(ww[0])
      return torch.exp(_sum(la * w, axis) / _sum(w, axis))
    return torch.exp(_mean(la, axis))
  return _weighted(a, weights, kern)


def hmean(a, axis=0, dtype=None, weights=None):
  """Harmonic mean."""
  def kern(aa, *ww):
    inv = 1.0 / _f(aa)
    if ww:
      w = _f(ww[0])
      return _sum(w, axis) / _sum(inv * w, axis)
    return 1.0 / _mean(inv, axis)
  return _weighted(a, weights, kern)


def pmean(a, p, axis=0, dtype=None, weights=None):
  """Power (generalized) mean of order p."""
  if p == 0:
    return gmean(a, axis=axis, dtype=dtype, weights=weights)

  def kern(aa, *ww):
    ap = _f(aa) ** p
    if ww:
      w = _f(ww[0])
      return (_sum(ap * w, axis) / _sum(w, axis)) ** (1.0 / p)
    return _mean(ap, axis) ** (1.0 / p)
  return _weighted(a, weights, kern)


def moment(a, order=1, axis=0, nan_policy="propagate", *, center=None):
  """Central moment of the given order."""
  def kern(aa):
    aa = _f(aa)
    c = _mean(aa, axis, keepdims=True) if center is None else center
    return _mean((aa - c) ** order, axis)
  return _mapn_whole(kern, a)


def _moments(aa, axis, *orders):
  m = _mean(aa, axis, keepdims=True)
  return [_mean((aa - m) ** k, axis) for k in orders]


def skew(a, axis=0, bias=True, nan_policy="propagate"):
  """Sample skewness (Fisher-Pearson; bias=False applies the
  G1 correction)."""
  def kern(aa):
    aa = _f(aa)
    m2, m3 = _moments(aa, axis, 2, 3)
    g1 = m3 / m2 ** 1.5
    if bias:
      return g1
    n = _count(aa, axis)
    return g1 * math.sqrt(n * (n - 1.0)) / (n - 2.0)
  return _mapn_whole(kern, a)


def kurtosis(a, axis=0, fisher=True, bias=True,
             nan_policy="propagate"):
  """Sample kurtosis (Fisher by default; bias=False applies G2)."""
  def kern(aa):
    aa = _f(aa)
    m2, m4 = _moments(aa, axis, 2, 4)
    g2 = m4 / m2 ** 2 - 3.0
    if not bias:
      n = _count(aa, axis)
      g2 = ((n - 1.0) / ((n - 2.0) * (n - 3.0))
            * ((n + 1.0) * g2 + 6.0))
    return g2 if fisher else g2 + 3.0
  return _mapn_whole(kern, a)


def _mode_last(x):
  """(smallest most common value, its count) along the last axis: runs of
  the stable sort, counted by a scatter-add of exact integers."""
  s = _sort.sort(x, -1)
  obs = torch.ones_like(s, dtype=torch.bool)
  obs[..., 1:] = s[..., 1:] != s[..., :-1]
  gid = torch.cumsum(obs, -1) - 1
  cnt = torch.zeros_like(gid).scatter_add_(-1, gid, torch.ones_like(gid))
  best = torch.argmax(cnt, -1, keepdim=True)  # the first: smallest value
  first = torch.argmax((gid == best).to(torch.int8), -1, keepdim=True)
  return (torch.take_along_dim(s, first, -1)[..., 0],
          torch.take_along_dim(cnt, best, -1)[..., 0])


def mode(a, axis=0, nan_policy="propagate", keepdims=False):
  """Most common value (scipy's smallest one among ties) and its count."""
  M = collections.namedtuple("ModeResult", ["mode", "count"])

  def kern(aa):
    x = torch.atleast_1d(aa)
    if axis is None:
      out = tuple(v.reshape((1,) * x.ndim if keepdims else ())
                  for v in _mode_last(x.reshape(-1)))
    else:
      ax = axis % x.ndim
      vals = _mode_last(x.movedim(ax, -1))
      out = tuple(v.unsqueeze(ax) if keepdims else v for v in vals)
    return out
  m, c = _map_multi(kern, 2, a)
  return M(m, c)


def sem(a, axis=0, ddof=1, nan_policy="propagate"):
  """Standard error of the mean."""
  def kern(aa):
    aa = _f(aa)
    return _std(aa, axis, ddof) / math.sqrt(_count(aa, axis))
  return _mapn_whole(kern, a)


def zscore(a, axis=0, ddof=0, nan_policy="propagate"):
  """Z-scores along an axis."""
  def kern(aa):
    aa = _f(aa)
    return ((aa - _mean(aa, axis, keepdims=True))
            / _std(aa, axis, ddof, keepdims=True))
  return _mapn_whole(kern, a)


def gzscore(a, axis=0, ddof=0, nan_policy="propagate"):
  """Geometric z-scores (z-scores of the logs)."""
  return zscore(sp.log(sp.lazify(a)), axis=axis, ddof=ddof)


def zmap(scores, compare, axis=0, ddof=0, nan_policy="propagate"):
  """Z-scores of ``scores`` relative to ``compare``."""
  def kern(ss, cc):
    cc = _f(cc)
    return ((_f(ss) - _mean(cc, axis, keepdims=True))
            / _std(cc, axis, ddof, keepdims=True))
  return _mapn_whole(kern, scores, compare)


def iqr(x, axis=None, rng=(25, 75), scale=1.0,
        nan_policy="propagate", interpolation="linear"):
  """Interquartile range (device percentiles)."""
  def kern(xx):
    q = _percentiles(_f(xx), rng, axis, interpolation)
    s = 1.3489795003921634 if scale == "normal" else scale  # 2*ndtri(3/4)
    return (q[1] - q[0]) / s
  return _mapn_whole(kern, x)


def median_abs_deviation(x, axis=0, center=None, scale=1.0,
                         nan_policy="propagate"):
  """Median absolute deviation; a ``center`` callable takes a torch tensor
  with ``axis`` and ``keepdims``, as ``torch``-based code would."""
  def kern(xx):
    xx = _f(xx)
    c = _median(xx, axis, keepdims=True) if center is None \
        else center(xx, axis=axis, keepdims=True)
    s = 0.6744897501960817 if scale == "normal" else scale
    return _median(torch.abs(xx - c), axis) / s
  return _mapn_whole(kern, x)


def variation(a, axis=0, nan_policy="propagate", ddof=0):
  """Coefficient of variation std/mean."""
  def kern(aa):
    aa = _f(aa)
    return _std(aa, axis, ddof) / _mean(aa, axis)
  return _mapn_whole(kern, a)


def tmean(a, limits=None, inclusive=(True, True), axis=None):
  """Trimmed mean over a value window."""
  return _trimmed(a, limits, inclusive, axis, "mean")


def tvar(a, limits=None, inclusive=(True, True), axis=0, ddof=1):
  """Trimmed variance."""
  return _trimmed(a, limits, inclusive, axis, "var", ddof=ddof)


def tstd(a, limits=None, inclusive=(True, True), axis=0, ddof=1):
  """Trimmed standard deviation."""
  return sp.sqrt(tvar(a, limits, inclusive, axis, ddof))


def tsem(a, limits=None, inclusive=(True, True), axis=0, ddof=1):
  """Trimmed standard error of the mean."""
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, limits, inclusive)
    n = _sum(m, axis)
    mu = _sum(torch.where(m, aa, 0.0), axis) / n
    v = (_sum(torch.where(m, (aa - mu.unsqueeze(axis or 0)) ** 2, 0.0),
              axis) / (n - ddof))
    return torch.sqrt(v / n)
  return _mapn_whole(kern, a)


def tmin(a, lowerlimit=None, axis=0, inclusive=True,
         nan_policy="propagate"):
  """Trimmed minimum."""
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, (lowerlimit, None), (inclusive, True))
    return torch.amin(torch.where(m, aa, math.inf), dim=_dims(aa, axis))
  return _mapn_whole(kern, a)


def tmax(a, upperlimit=None, axis=0, inclusive=True,
         nan_policy="propagate"):
  """Trimmed maximum."""
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, (None, upperlimit), (True, inclusive))
    return torch.amax(torch.where(m, aa, -math.inf), dim=_dims(aa, axis))
  return _mapn_whole(kern, a)


def _limit_mask(aa, limits, inclusive):
  m = torch.ones(aa.shape, dtype=torch.bool, device=aa.device)
  if limits is not None:
    lo, hi = limits
    il, ih = inclusive
    if lo is not None:
      m &= (aa >= lo) if il else (aa > lo)
    if hi is not None:
      m &= (aa <= hi) if ih else (aa < hi)
  return m


def _trimmed(a, limits, inclusive, axis, stat, ddof=1):
  def kern(aa):
    aa = _f(aa)
    m = _limit_mask(aa, limits, inclusive)
    n = _sum(m, axis)
    mu = _sum(torch.where(m, aa, 0.0), axis) / n
    if stat == "mean":
      return mu
    c = aa - (mu.unsqueeze(axis) if axis is not None else mu)
    return _sum(torch.where(m, c * c, 0.0), axis) / (n - ddof)
  return _mapn_whole(kern, a)


def trim_mean(a, proportiontocut, axis=0):
  """Mean with the given fraction cut from each tail (sorted trim)."""
  def kern(aa):
    aa = _f(aa)
    aa = _sort.sort(aa.reshape(-1) if axis is None else aa,
                    0 if axis is None else axis)
    ax = 0 if axis is None else axis
    n = aa.shape[ax]
    k = int(n * proportiontocut)
    return _mean(aa.narrow(ax, k, n - 2 * k), axis)
  return _mapn_whole(kern, a)


def _rank_last(x, method):
  """scipy's ranks along the last axis (jax.scipy.stats.rankdata's
  definition): runs of equal values in the stable sort order."""
  n = x.shape[-1]
  order = _sort.argsort(x, -1)
  s = torch.take_along_dim(x, order, -1)
  idx = torch.arange(n, device=x.device).expand_as(order)
  inv = torch.empty_like(order).scatter_(-1, order, idx)
  if method == "ordinal":
    return inv + 1
  obs = torch.ones_like(s, dtype=torch.bool)
  obs[..., 1:] = s[..., 1:] != s[..., :-1]
  if method == "dense":
    return torch.take_along_dim(torch.cumsum(obs, -1), inv, -1)
  start = torch.cummax(torch.where(obs, idx, 0), -1).values
  last = torch.ones_like(obs)
  last[..., :-1] = obs[..., 1:]
  end = torch.flip(torch.cummin(torch.flip(torch.where(last, idx, n), (-1,)),
                                -1).values, (-1,))
  lo = torch.take_along_dim(start, inv, -1) + 1
  hi = torch.take_along_dim(end, inv, -1) + 1
  if method == "min":
    return lo
  if method == "max":
    return hi
  return 0.5 * (lo + hi).to(torch.float64)


def _rankdata(x, method="average", axis=None):
  if method not in ("average", "min", "max", "dense", "ordinal"):
    raise ValueError(f"unknown method '{method}'")
  if axis is None:
    return _rank_last(x.reshape(-1), method)
  return _rank_last(x.movedim(axis, -1), method).movedim(-1, axis)


def rankdata(a, method="average", *, axis=None,
             nan_policy="propagate"):
  """Ranks of the data along ``axis`` (all of it flattened for None)."""
  if method not in ("average", "min", "max", "dense", "ordinal"):
    raise ValueError(f"unknown method '{method}'")
  return _mapn_whole(lambda aa: _rankdata(_f(aa), method, axis), a)


def entropy(pk, qk=None, base=None, axis=0, *, nan_policy="propagate"):
  """Shannon entropy (or relative entropy when qk is given)."""
  def kern(pp, *qq):
    pp = _f(pp)
    pp = pp / _sum(pp, axis, keepdims=True)
    if qq:
      q = _f(qq[0])
      q = q / _sum(q, axis, keepdims=True)
      out = _sum(_rel_entr(pp, q), axis)
    else:
      out = _sum(_entr(pp), axis)
    return out / np.log(base) if base is not None else out
  return _weighted(pk, qk, kern)


def _angles(ss, high, low):
  return (_f(ss) - low) * 2 * np.pi / (high - low)


def _resultant(ss, high, low, axis):
  ang = _angles(ss, high, low)
  return _mean(torch.sin(ang), axis), _mean(torch.cos(ang), axis)


def circmean(samples, high=2 * np.pi, low=0, axis=None,
             nan_policy="propagate"):
  """Circular mean."""
  def kern(ss):
    s, c = _resultant(ss, high, low, axis)
    out = torch.arctan2(s, c)
    return torch.remainder(out, 2 * np.pi) * (high - low) / (2 * np.pi) + low
  return _mapn_whole(kern, samples)


def circvar(samples, high=2 * np.pi, low=0, axis=None,
            nan_policy="propagate"):
  """Circular variance 1 - |R|."""
  def kern(ss):
    s, c = _resultant(ss, high, low, axis)
    return 1.0 - torch.sqrt(s ** 2 + c ** 2)
  return _mapn_whole(kern, samples)


def circstd(samples, high=2 * np.pi, low=0, axis=None,
            nan_policy="propagate", *, normalize=False):
  """Circular standard deviation sqrt(-2 ln R)."""
  def kern(ss):
    s, c = _resultant(ss, high, low, axis)
    out = torch.sqrt(-2 * torch.log(torch.sqrt(s ** 2 + c ** 2)))
    if not normalize:
      out = out * (high - low) / (2 * np.pi)
    return out
  return _mapn_whole(kern, samples)


def gstd(a, axis=0, ddof=1):
  """Geometric standard deviation."""
  return sp.exp(_mapn_whole(
      lambda aa: _std(torch.log(_f(aa)), axis, ddof), a))


def describe(a, axis=0, ddof=1, bias=True, nan_policy="propagate"):
  """Summary statistics (scipy's DescribeResult); ``axis=None`` describes
  the flattened array, as scipy does."""
  D = collections.namedtuple(
      "DescribeResult",
      ["nobs", "minmax", "mean", "variance", "skewness", "kurtosis"])
  A = sp.lazify(a)
  n = int(np.prod(A.shape)) if axis is None else A.shape[axis]
  return D(n, (sp.min(A, axis=axis), sp.max(A, axis=axis)),
           sp.mean(A, axis=axis),
           _mapn_whole(lambda aa: _var(_f(aa), axis, ddof), a),
           skew(a, axis=axis, bias=bias),
           kurtosis(a, axis=axis, bias=bias))


# ---------------------------------------------------------------------
# correlation + hypothesis tests (device statistic; p-values through
# the betainc/gammainc/ndtr/kolmogorov identities)
# ---------------------------------------------------------------------

_TT = collections.namedtuple("TtestResult", ["statistic", "pvalue"])
_PR = collections.namedtuple("PearsonRResult", ["statistic", "pvalue"])
_KS = collections.namedtuple("KstestResult", ["statistic", "pvalue"])
_CH = collections.namedtuple("Power_divergenceResult",
                             ["statistic", "pvalue"])
_F1 = collections.namedtuple("F_onewayResult", ["statistic", "pvalue"])
_SG = collections.namedtuple("SignificanceResult",
                             ["statistic", "pvalue"])
_NT = collections.namedtuple("NormaltestResult",
                             ["statistic", "pvalue"])
_LR = collections.namedtuple(
    "LinregressResult",
    ["slope", "intercept", "rvalue", "pvalue", "stderr",
     "intercept_stderr"])


def _t_sf2(tstat, df):
  """Two-sided t p-value via the betainc identity (device)."""
  return _betainc(df / 2, torch.full_like(tstat, 0.5), df / (df + tstat * tstat))


def _t_alt(tstat, df, alternative):
  p2 = _t_sf2(tstat, df)
  if alternative == "two-sided":
    return p2
  one = torch.where(tstat >= 0, p2 / 2, 1 - p2 / 2)
  return one if alternative == "greater" else 1 - one


def _like(v, x):
  """A 0-d parameter in ``x``'s dtype (a weak scalar's role)."""
  v = _f(v)
  return v.to(x.dtype) if v.ndim == 0 and x.is_floating_point() else v


def ttest_1samp(a, popmean, axis=0, nan_policy="propagate",
                alternative="two-sided"):
  """One-sample t-test — statistic and p both on device."""
  def kern(aa, pm):
    aa = _f(aa)
    n = _count(aa, axis)
    d = _mean(aa, axis) - _like(pm, aa)
    se = _std(aa, axis, 1) / math.sqrt(n)
    tstat = d / se
    return tstat, _t_alt(tstat, torch.full_like(tstat, float(n - 1)), alternative)
  s, p = _map_multi(kern, 2, a, popmean)
  return _TT(s, p)


def ttest_ind(a, b, axis=0, equal_var=True, nan_policy="propagate",
              alternative="two-sided"):
  """Two-sample t-test (pooled or Welch)."""
  def kern(aa, bb):
    aa, bb = _f(aa), _f(bb)
    na, nb = _count(aa, axis), _count(bb, axis)
    va, vb = _var(aa, axis, 1), _var(bb, axis, 1)
    d = _mean(aa, axis) - _mean(bb, axis)
    if equal_var:
      sp2 = ((na - 1) * va + (nb - 1) * vb) / (na + nb - 2)
      se = torch.sqrt(sp2 * (1.0 / na + 1.0 / nb))
      df = torch.full_like(se, float(na + nb - 2))
    else:
      se = torch.sqrt(va / na + vb / nb)
      df = ((va / na + vb / nb) ** 2
            / ((va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1)))
    tstat = d / se
    return tstat, _t_alt(tstat, df, alternative)
  s, p = _map_multi(kern, 2, a, b)
  return _TT(s, p)


def ttest_rel(a, b, axis=0, nan_policy="propagate",
              alternative="two-sided"):
  """Paired t-test."""
  return ttest_1samp(sp.lazify(a) - sp.lazify(b), 0.0, axis=axis,
                     alternative=alternative)


def _pearson(xx, yy, axis, alternative):
  n = _count(xx, axis)
  xm = xx - _mean(xx, axis, keepdims=True)
  ym = yy - _mean(yy, axis, keepdims=True)
  r = (_sum(xm * ym, axis)
       / torch.sqrt(_sum(xm * xm, axis) * _sum(ym * ym, axis)))
  r = torch.clip(r, -1.0, 1.0)
  df = torch.full_like(r, float(n - 2))
  tstat = r * torch.sqrt(df / torch.clamp_min(1.0 - r * r, 1e-300))
  return r, _t_alt(tstat, df, alternative)


def pearsonr(x, y, *, alternative="two-sided", method=None, axis=0):
  """Pearson correlation with the exact t-based p-value."""
  def kern(xx, yy):
    return _pearson(_f(xx), _f(yy), axis, alternative)
  s, p = _map_multi(kern, 2, x, y)
  return _PR(s, p)


def spearmanr(a, b=None, axis=0, nan_policy="propagate",
              alternative="two-sided"):
  """Spearman rank correlation (device ranks + Pearson on ranks)."""
  if b is None:
    raise NotImplementedError("matrix form routes host: use "
                              "scipy.stats.spearmanr")
  ra = rankdata(a, axis=axis)
  rb = rankdata(b, axis=axis)
  out = pearsonr(ra, rb, alternative=alternative, axis=axis)
  return _SG(out.statistic, out.pvalue)


def pointbiserialr(x, y):
  """Point-biserial correlation (Pearson on the binary coding)."""
  out = pearsonr(x, y)
  return _SG(out.statistic, out.pvalue)


def kstest(rvs, cdf, args=(), N=20, alternative="two-sided",
           method="auto", axis=0):
  """One-sample KS test against a device-distribution cdf (asymptotic
  kolmogorov p with Stephens' correction)."""
  if isinstance(cdf, str):
    cdf_dist = _DEVICE_DISTS.get(cdf)
    if cdf_dist is None:
      return _host_call("kstest", rvs, cdf, args=args, N=N,
                        alternative=alternative, method=method)
    cdf = lambda x: cdf_dist.cdf(x, *args)  # noqa: E731
  X = sp.lazify(rvs)
  n = X.shape[0]
  F = sp.lazify(cdf(sp.sort(X)))

  def kern(ff):
    ff = _f(ff)
    i = torch.arange(1, n + 1, dtype=ff.dtype, device=ff.device)
    dplus = torch.amax(i / n - ff)
    dminus = torch.amax(ff - (i - 1) / n)
    d = torch.maximum(dplus, dminus)
    p = _kolmogorov_kern(d * (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)))
    return d, torch.clip(p, 0.0, 1.0)
  s, p = _map_multi(kern, 2, F)
  return _KS(s, p)


def ks_1samp(x, cdf, args=(), alternative="two-sided", method="auto",
             axis=0):
  """Alias of ``kstest`` for the one-sample form."""
  return kstest(x, cdf, args=args, alternative=alternative,
                method=method)


def ks_2samp(data1, data2, alternative="two-sided", method="auto",
             axis=0):
  """Two-sample KS test (device statistic; asymptotic p)."""
  X, Y = sp.lazify(data1), sp.lazify(data2)
  n1, n2 = X.shape[0], Y.shape[0]

  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    dt = torch.promote_types(xx.dtype, yy.dtype)
    xx, yy = _sort.sort(xx.to(dt)), _sort.sort(yy.to(dt))
    allv = torch.cat([xx, yy])
    cdf1 = _searchsorted(xx, allv, True).to(xx.dtype) / n1
    cdf2 = _searchsorted(yy, allv, True).to(yy.dtype) / n2
    d = torch.amax(torch.abs(cdf1 - cdf2))
    en = np.sqrt(n1 * n2 / (n1 + n2))
    p = _kolmogorov_kern((en + 0.12 + 0.11 / en) * d)
    return d, torch.clip(p, 0.0, 1.0)
  s, p = _map_multi(kern, 2, X, Y)
  return _KS(s, p)


def _chi2_sf(df, stat):
  return _gammaincc(torch.full_like(stat, df) / 2, stat / 2)


def power_divergence(f_obs, f_exp=None, ddof=0, axis=0, lambda_=None):
  """Cressie-Read power divergence (chisquare family)."""
  if lambda_ is None:
    lambda_ = 1.0
  elif isinstance(lambda_, str):
    lambda_ = {"pearson": 1.0, "log-likelihood": 0.0,
               "freeman-tukey": -0.5, "mod-log-likelihood": -1.0,
               "neyman": -2.0, "cressie-read": 2.0 / 3.0}[lambda_]

  def kern(fo, *fe):
    fo = _f(fo)
    n = _count(fo, axis)
    fx = _f(fe[0]) if fe else _mean(fo, axis, keepdims=True) \
        + torch.zeros_like(fo)
    if lambda_ == 1.0:
      stat = _sum((fo - fx) ** 2 / fx, axis)
    elif lambda_ == 0.0:
      stat = 2.0 * _sum(_xlogy(fo, fo / fx), axis)
    else:
      stat = (2.0 / (lambda_ * (lambda_ + 1))
              * _sum(fo * ((fo / fx) ** lambda_ - 1), axis))
    return stat, _chi2_sf(float(n - 1 - ddof), stat)
  s, p = _map_multi(kern, 2, *([f_obs] + ([f_exp] if f_exp is not None
                                         else [])))
  return _CH(s, p)


def chisquare(f_obs, f_exp=None, ddof=0, axis=0, *,
              sum_check=True):
  """Chi-square goodness of fit."""
  return power_divergence(f_obs, f_exp, ddof=ddof, axis=axis,
                          lambda_=1.0)


def _f_sf(dfb, dfw, F):
  return _betainc(torch.full_like(F, dfw / 2), torch.full_like(F, dfb / 2),
                  dfw / (dfw + dfb * F))


def f_oneway(*samples, axis=0):
  """One-way ANOVA — F statistic + fdtrc p, all device."""
  k = len(samples)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    ns = [_count(s, axis) for s in ss]
    n = sum(ns)
    grand = sum(_sum(s, axis) for s in ss) / n
    ssb = sum(ni * (_mean(s, axis) - grand) ** 2
              for s, ni in zip(ss, ns))
    ssw = sum(_sum((s - _mean(s, axis, keepdims=True)) ** 2, axis)
              for s in ss)
    dfb, dfw = float(k - 1), float(n - k)
    F = (ssb / dfb) / (ssw / dfw)
    return F, _f_sf(dfb, dfw, F)
  s, p = _map_multi(kern, 2, *samples)
  return _F1(s, p)


def bartlett(*samples, axis=0):
  """Bartlett's equal-variance test (chi2 p on device)."""
  k = len(samples)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    ns = [_count(s, axis) for s in ss]
    N = sum(ns)
    vs = [_var(s, axis, 1) for s in ss]
    sp2 = sum((ni - 1) * v for ni, v in zip(ns, vs)) / (N - k)
    num = ((N - k) * torch.log(sp2)
           - sum((ni - 1) * torch.log(v) for ni, v in zip(ns, vs)))
    C = 1 + (sum(1.0 / (ni - 1) for ni in ns) - 1.0 / (N - k)) \
        / (3 * (k - 1))
    stat = num / C
    return stat, _chi2_sf(float(k - 1), stat)
  s, p = _map_multi(kern, 2, *samples)
  return _SG(s, p)


def levene(*samples, center="median", proportiontocut=0.05, axis=0):
  """Levene's equal-variance test (Brown-Forsythe for median)."""
  k = len(samples)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    ns = [_count(s, axis) for s in ss]
    N = sum(ns)
    if center == "median":
      zs = [torch.abs(s - _median(s, axis, keepdims=True)) for s in ss]
    else:
      zs = [torch.abs(s - _mean(s, axis, keepdims=True)) for s in ss]
    zbars = [_mean(z, axis) for z in zs]
    zgrand = sum(_sum(z, axis) for z in zs) / N
    num = (N - k) * sum(ni * (zb - zgrand) ** 2
                        for ni, zb in zip(ns, zbars))
    den = (k - 1) * sum(_sum((z - _mean(z, axis, keepdims=True)) ** 2, axis)
                        for z in zs)
    W = num / den
    return W, _f_sf(float(k - 1), float(N - k), W)
  s, p = _map_multi(kern, 2, *samples)
  return _SG(s, p)


def jarque_bera(x, *, axis=None):
  """Jarque-Bera normality test."""
  def kern(xx):
    xx = _f(xx)
    n = _count(xx, axis)
    m2, m3, m4 = _moments(xx, axis, 2, 3, 4)
    s = m3 / m2 ** 1.5
    kk = m4 / m2 ** 2
    stat = n / 6.0 * (s * s + (kk - 3) ** 2 / 4)
    return stat, torch.exp(-stat / 2)   # chi2(2) survival
  s, p = _map_multi(kern, 2, x)
  return _SG(s, p)


def _z_alt(Z, alternative):
  if alternative == "two-sided":
    return 2 * _ndtr(-torch.abs(Z))
  one = _ndtr(-Z)
  return one if alternative == "greater" else 1 - one


def _skew_z(aa, axis):
  n = float(_count(aa, axis))
  m2, m3 = _moments(aa, axis, 2, 3)
  b2 = m3 / m2 ** 1.5
  y = b2 * math.sqrt((n + 1) * (n + 3) / (6.0 * (n - 2)))
  beta2 = (3.0 * (n ** 2 + 27 * n - 70) * (n + 1) * (n + 3)
           / ((n - 2.0) * (n + 5) * (n + 7) * (n + 9)))
  W2 = -1.0 + math.sqrt(2 * (beta2 - 1))
  delta = 1 / math.sqrt(0.5 * math.log(W2))
  alpha = math.sqrt(2.0 / (W2 - 1))
  y = torch.where(y == 0, 1.0, y)
  return delta * torch.log(y / alpha + torch.sqrt((y / alpha) ** 2 + 1))


def skewtest(a, axis=0, nan_policy="propagate",
             alternative="two-sided"):
  """D'Agostino skewness test (Z-transform on device)."""
  def kern(aa):
    Z = _skew_z(_f(aa), axis)
    return Z, _z_alt(Z, alternative)
  s, p = _map_multi(kern, 2, a)
  return _SG(s, p)


def _kurtosis_z(aa, axis):
  n = float(_count(aa, axis))
  m2, m4 = _moments(aa, axis, 2, 4)
  b2 = m4 / m2 ** 2
  E = 3.0 * (n - 1) / (n + 1)
  var = (24.0 * n * (n - 2) * (n - 3)
         / ((n + 1) ** 2 * (n + 3) * (n + 5)))
  x = (b2 - E) / math.sqrt(var)
  beta1 = (6.0 * (n ** 2 - 5 * n + 2) / ((n + 7) * (n + 9))
           * math.sqrt(6.0 * (n + 3) * (n + 5) / (n * (n - 2) * (n - 3))))
  A = 6.0 + 8.0 / beta1 * (2.0 / beta1 + math.sqrt(1 + 4.0 / beta1 ** 2))
  return ((1 - 2.0 / (9 * A))
          - ((1 - 2.0 / A) / (1 + x * math.sqrt(2.0 / (A - 4))))
          ** (1.0 / 3)) / math.sqrt(2.0 / (9 * A))


def kurtosistest(a, axis=0, nan_policy="propagate",
                 alternative="two-sided"):
  """Anscombe-Glynn kurtosis test."""
  def kern(aa):
    Z = _kurtosis_z(_f(aa), axis)
    return Z, _z_alt(Z, alternative)
  s, p = _map_multi(kern, 2, a)
  return _SG(s, p)


def normaltest(a, axis=0, nan_policy="propagate"):
  """D'Agostino-Pearson omnibus normality test K²."""
  s = skewtest(a, axis=axis)
  k = kurtosistest(a, axis=axis)
  k2 = sp.lazify(s.statistic) ** 2 + sp.lazify(k.statistic) ** 2
  p = _mapn(lambda st: torch.exp(-_f(st) / 2), k2)
  return _NT(k2, p)


def linregress(x, y=None, alternative="two-sided"):
  """Simple linear regression with full scipy result fields; with ``y``
  None, ``x`` holds the two rows (or columns) of a 2 x N array."""
  if y is None:
    X = sp.lazify(x)
    x, y = (X[0], X[1]) if X.shape[0] == 2 else (X[:, 0], X[:, 1])

  def kern(xx, yy):
    xx, yy = _f(xx), _f(yy)
    n = float(xx.shape[0])
    xm, ym = xx.mean(), yy.mean()
    sxx = ((xx - xm) ** 2).sum()
    sxy = ((xx - xm) * (yy - ym)).sum()
    syy = ((yy - ym) ** 2).sum()
    slope = sxy / sxx
    intercept = ym - slope * xm
    r = torch.clip(sxy / torch.sqrt(sxx * syy), -1.0, 1.0)
    df = torch.full_like(r, n - 2)
    tstat = r * torch.sqrt(df / torch.clamp_min(1 - r * r, 1e-300))
    p = _t_alt(tstat, df, alternative)
    resid = syy - slope * sxy
    se = torch.sqrt(resid / df / sxx)
    se_i = se * torch.sqrt((xx * xx).mean())
    return slope, intercept, r, p, se, se_i
  return _LR(*_map_multi(kern, 6, x, y))


def _tie_term(allv):
  """sum(t^3 - t) over the groups of equal values: the sorted runs counted
  by ``index_add_`` of exact small integers."""
  n = allv.shape[0]
  sv = _sort.sort(allv)
  newg = torch.ones(n, dtype=torch.bool, device=allv.device)
  newg[1:] = sv[1:] != sv[:-1]
  gid = torch.cumsum(newg, 0) - 1
  tc = torch.zeros(n, dtype=sv.dtype, device=sv.device).index_add_(
      0, gid, torch.ones_like(sv))
  return (tc ** 3 - tc).sum()


def _pooled(xx, yy):
  xx, yy = _f(xx), _f(yy)
  dt = torch.promote_types(xx.dtype, yy.dtype)
  return torch.cat([xx.to(dt), yy.to(dt)])


def mannwhitneyu(x, y, use_continuity=True, alternative="two-sided",
                 axis=0, method="auto"):
  """Mann-Whitney U (normal approximation with tie correction)."""
  X, Y = sp.lazify(x), sp.lazify(y)
  n1, n2 = X.shape[0], Y.shape[0]

  def kern(xx, yy):
    allv = _pooled(xx, yy)
    r = _rank_last(allv, "average").to(allv.dtype)
    R1 = r[:n1].sum()
    U1 = R1 - n1 * (n1 + 1) / 2.0
    n = n1 + n2
    tie = _tie_term(allv)
    mu = n1 * n2 / 2.0
    s2 = n1 * n2 / 12.0 * ((n + 1) - tie / (n * (n - 1.0)))
    if alternative == "two-sided":
      num = torch.abs(U1 - mu)
    elif alternative == "greater":
      num = U1 - mu
    else:
      num = mu - U1
    cc = 0.5 if use_continuity else 0.0
    z = (num - cc) / torch.sqrt(s2)
    p = _ndtr(-z)
    p = torch.clip(2 * p if alternative == "two-sided" else p, 0.0, 1.0)
    return U1, p
  s, p = _map_multi(kern, 2, X, Y)
  M = collections.namedtuple("MannwhitneyuResult",
                             ["statistic", "pvalue"])
  return M(s, p)


def ranksums(x, y, alternative="two-sided", *, axis=0):
  """Wilcoxon rank-sum test (normal approximation)."""
  X, Y = sp.lazify(x), sp.lazify(y)
  n1, n2 = X.shape[0], Y.shape[0]

  def kern(xx, yy):
    allv = _pooled(xx, yy)
    r = _rank_last(allv, "average").to(allv.dtype)
    R1 = r[:n1].sum()
    mu = n1 * (n1 + n2 + 1) / 2.0
    z = (R1 - mu) / math.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
    return z, _z_alt(z, alternative)
  s, p = _map_multi(kern, 2, X, Y)
  return _SG(s, p)


def kruskal(*samples, nan_policy="propagate", axis=0):
  """Kruskal-Wallis H test (device ranks + chi2 p)."""
  ops = [sp.lazify(s) for s in samples]
  ns = [o.shape[0] for o in ops]
  k = len(ops)

  def kern(*ss):
    ss = [_f(s) for s in ss]
    dt = functools.reduce(torch.promote_types, [s.dtype for s in ss])
    allv = torch.cat([s.to(dt) for s in ss])
    n = allv.shape[0]
    r = _rank_last(allv, "average").to(dt)
    H = 0.0
    off = 0
    for ni in ns:
      H = H + r[off:off + ni].sum() ** 2 / ni
      off += ni
    H = 12.0 / (n * (n + 1)) * H - 3 * (n + 1)
    H = H / (1.0 - _tie_term(allv) / (float(n) ** 3 - n))
    return H, _chi2_sf(float(k - 1), H)
  s, p = _map_multi(kern, 2, *ops)
  K = collections.namedtuple("KruskalResult", ["statistic", "pvalue"])
  return K(s, p)


def combine_pvalues(pvalues, method="fisher", weights=None):
  """Combine p-values (Fisher / Stouffer on device)."""
  if method not in ("fisher", "stouffer"):
    raise ValueError(f"unsupported method {method!r}")

  def kern(pp):
    pp = _f(pp)
    k = pp.shape[0]
    if method == "fisher":
      stat = -2.0 * torch.log(pp).sum()
      return stat, _chi2_sf(float(2 * k), stat)
    z = _ndtri(1.0 - pp)
    stat = z.sum() / np.sqrt(k)
    return stat, _ndtr(-stat)
  s, p = _map_multi(kern, 2, pvalues)
  return _SG(s, p)


# ---------------------------------------------------------------------
# gaussian_kde: jax.scipy.stats.gaussian_kde's surface over torch
# ---------------------------------------------------------------------

_KDE_BLOCK = 1 << 28  # pairwise elements evaluated at a time


class gaussian_kde:
  """Gaussian kernel density estimate (``jax.scipy.stats.gaussian_kde``'s
  surface): ``d``, ``n``, ``dataset`` (d, n), ``weights``, ``neff``,
  ``covariance``, ``inv_cov`` as torch tensors on the mesh's device;
  ``evaluate``/``__call__``/``pdf``/``logpdf`` return lazy Exprs (the
  pairwise sums a ``torch.matmul`` of whitened points, in blocks of
  2^28 pairs).  ``resample`` takes an int seed or a ``torch.Generator``
  where jax takes a key.  ``set_bandwidth`` and the box integral in more
  than one dimension raise, as jax's do."""

  def __init__(self, dataset, bw_method=None, weights=None):
    ds = torch.as_tensor(np.ascontiguousarray(np.atleast_2d(
        _host_value(dataset))), device=sp.get_mesh().device)
    if ds.is_complex():
      raise NotImplementedError("gaussian_kde does not support complex data")
    if not ds.numel() > 1:
      raise ValueError("`dataset` input should have multiple elements.")
    ds = _f(ds)
    d, n = ds.shape
    if weights is not None:
      w = _f(torch.as_tensor(np.ascontiguousarray(np.atleast_1d(
          _host_value(weights))), device=ds.device))
      dt = torch.promote_types(ds.dtype, w.dtype)
      ds, w = ds.to(dt), w.to(dt)
      if w.ndim != 1:
        raise ValueError("`weights` input should be one-dimensional.")
      if len(w) != n:
        raise ValueError("`weights` input should be of length n")
      w = w / w.sum()
    else:
      w = torch.full((n,), 1.0 / n, dtype=ds.dtype, device=ds.device)
    self.dataset, self.weights = ds, w
    self.neff = 1 / torch.sum(w ** 2)
    bw_method = "scott" if bw_method is None else bw_method
    if bw_method == "scott":
      factor = self.neff ** (-1. / (d + 4))
    elif bw_method == "silverman":
      factor = (self.neff * (d + 2) / 4.0) ** (-1. / (d + 4))
    elif np.isscalar(bw_method) and not isinstance(bw_method, str):
      factor = bw_method
    elif callable(bw_method):
      factor = bw_method(self)
    else:
      raise ValueError("`bw_method` should be 'scott', 'silverman', a "
                       "scalar, or a callable.")
    cov = torch.atleast_2d(torch.cov(ds, correction=1, aweights=w))
    self.covariance = cov * factor ** 2
    self.inv_cov = torch.linalg.inv(cov) / factor ** 2

  @property
  def d(self):
    return self.dataset.shape[0]

  @property
  def n(self):
    return self.dataset.shape[1]

  def _points(self, points):
    def kern(pp):
      pp = torch.atleast_2d(_f(pp))
      if pp.is_complex():
        raise NotImplementedError(
            "gaussian_kde does not support complex coordinates")
      dd, m = pp.shape
      if dd != self.d:
        if dd == 1 and m == self.d:
          pp = pp.reshape(self.d, 1)
        else:
          raise ValueError(f"points have dimension {dd}, dataset has "
                           f"dimension {self.d}")
      return pp
    return kern

  def _eval(self, points, in_log):
    shape_points = self._points(points)

    def kern(pp):
      xi = shape_points(pp)
      dt = torch.promote_types(xi.dtype, self.dataset.dtype)
      xi = xi.to(dt)
      if xi.is_meta:
        return torch.empty(xi.shape[1], dtype=dt, device="meta")
      whiten = torch.linalg.cholesky(self.inv_cov.to(dt))
      pts = self.dataset.to(dt).T @ whiten       # (n, d)
      q = xi.to(pts.device).T @ whiten           # (m, d)
      log_norm = (torch.log(torch.diagonal(whiten)).sum()
                  - 0.5 * self.d * math.log(2 * math.pi))
      pn = (pts * pts).sum(1)
      w = self.weights.to(dt)
      rows = max(1, _KDE_BLOCK // self.n)
      out = []
      for s in range(0, q.shape[0], rows):
        qb = q[s:s + rows]
        d2 = torch.clamp_min((qb * qb).sum(1)[:, None] + pn[None, :]
                             - 2.0 * (qb @ pts.T), 0.0)
        arg = log_norm - 0.5 * d2
        if in_log:
          out.append(torch.logsumexp(torch.log(w)[None, :] + arg, 1))
        else:
          out.append(torch.exp(arg) @ w)
      return torch.cat(out)
    return _mapn_whole(kern, points)

  def evaluate(self, points):
    return self._eval(points, False)

  def __call__(self, points):
    return self.evaluate(points)

  def pdf(self, x):
    return self.evaluate(x)

  def logpdf(self, x):
    return self._eval(x, True)

  def _convolve(self, cov, target, weights, mean):
    """sum_i w_i N(mean; target_i, cov) for each column of ``mean``."""
    chol = torch.linalg.cholesky(cov)
    norm = 1.0 / (math.sqrt(2 * math.pi) ** self.d
                  * torch.prod(torch.diagonal(chol)))
    diff = target[:, :, None] - mean[:, None, :]        # (d, n, m)
    alpha = torch.cholesky_solve(diff.reshape(self.d, -1), chol)
    arg = 0.5 * (diff.reshape(self.d, -1) * alpha).sum(0).reshape(diff.shape[1:])
    return norm * (torch.exp(-arg) * weights[:, None]).sum(0)

  def integrate_gaussian(self, mean, cov):
    mean = torch.atleast_1d(torch.as_tensor(np.ascontiguousarray(
        _host_value(mean)), device=self.dataset.device).squeeze())
    cov = torch.atleast_2d(torch.as_tensor(np.ascontiguousarray(
        _host_value(cov)), device=self.dataset.device))
    if mean.shape != (self.d,):
      raise ValueError(f"mean does not have dimension {self.d}")
    if cov.shape != (self.d, self.d):
      raise ValueError(f"covariance does not have dimension {self.d}")
    dt = self.dataset.dtype
    return self._convolve(self.covariance + cov.to(dt), self.dataset,
                          self.weights, mean.to(dt)[:, None])[0]

  def integrate_box_1d(self, low, high):
    if self.d != 1:
      raise ValueError("integrate_box_1d() only handles 1D pdfs")
    if np.ndim(low) != 0 or np.ndim(high) != 0:
      raise ValueError(
          "the limits of integration in integrate_box_1d must be scalars")
    sigma = torch.sqrt(self.covariance).squeeze()
    lo = ((low - self.dataset) / sigma).squeeze()
    hi = ((high - self.dataset) / sigma).squeeze()
    return torch.sum(self.weights * (_ndtr(hi) - _ndtr(lo)))

  def integrate_kde(self, other):
    if other.d != self.d:
      raise ValueError("KDEs are not the same dimensionality")
    sm, lg = (self, other) if self.n < other.n else (other, self)
    vals = self._convolve(self.covariance + other.covariance, lg.dataset,
                          lg.weights, sm.dataset)
    return torch.sum(vals * sm.weights)

  def resample(self, seed=None, shape=()):
    """``shape`` draws of the estimate, as ``(d,) + shape``: a kernel centre
    chosen by the weights and a normal offset of the kernel covariance.
    ``seed`` is an int or a ``torch.Generator`` on the dataset's device."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=self.dataset.device).manual_seed(
            int(seed) if seed is not None else
            int(np.random.SeedSequence().entropy % (2 ** 31)))
    shape = tuple(np.atleast_1d(shape).astype(int)) if np.ndim(shape) \
        else ((int(shape),) if shape != () else ())
    count = int(np.prod(shape)) if shape else 1
    ind = torch.multinomial(self.weights, count, replacement=True,
                            generator=gen)
    chol = torch.linalg.cholesky(self.covariance)
    eps = chol @ torch.randn((self.d, count), dtype=self.dataset.dtype,
                             device=self.dataset.device, generator=gen)
    return (self.dataset[:, ind] + eps).reshape((self.d,) + shape)

  def integrate_box(self, low_bounds, high_bounds, maxpts=None):
    del low_bounds, high_bounds, maxpts
    raise NotImplementedError(
        "only 1D box integrations are supported; use `integrate_box_1d`")

  def set_bandwidth(self, bw_method=None):
    del bw_method
    raise NotImplementedError(
        "dynamically changing the bandwidth method is not supported")


# ---------------------------------------------------------------------
# host boundary: the rest of scipy.stats (exotic distributions keep
# their full scipy API as re-exported objects), counted in
# ``expr.fio.counts["host_runs"]``
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.stats.%s: no device implementation — runs EAGERLY on "
           "the host (scipy.stats), the sp.linalg.eig convention.", name)


def _host_call(name, *args, **kw):
  _host_notice(name)
  fio.counts["host_runs"] += 1
  return getattr(_sst, name)(*[_host_value(a) for a in args], **kw)


def _host_stats(name):
  def op(*args, **kw):
    return _host_call(name, *args, **kw)
  op.__name__ = name
  op.__doc__ = (f"scipy.stats.{name} — host boundary (an eager scipy "
                "call, counted in expr.fio.counts['host_runs']).")
  return op


_HOST_NAMES = []
for _n in dir(_sst):
  if _n.startswith("_") or _n in globals():
    continue
  _obj = getattr(_sst, _n)
  if _inspect.ismodule(_obj):
    globals()[_n] = _obj       # public submodules (qmc/contingency/
    continue                   # mstats/...) re-export whole, host
  if (_inspect.isclass(_obj) or not _py_callable(_obj)
      or isinstance(_obj, (_sst.rv_continuous, _sst.rv_discrete))
      or type(_obj).__module__.startswith("scipy.stats")):
    globals()[_n] = _obj       # result classes, rv_* bases, frozen
    _HOST_NAMES.append(_n)     # distribution objects (full scipy API)
  else:
    globals()[_n] = _host_stats(_n)
    _HOST_NAMES.append(_n)
_HOST_NAMES = sorted(_HOST_NAMES)

__all__ = sorted(n for n in dir()
                 if not n.startswith("_") and n not in
                 ("annotations", "collections", "functools", "math", "np",
                  "sp", "structural", "torch", "fio", "log_info"))
