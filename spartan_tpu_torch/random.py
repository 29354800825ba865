"""``sp.random``: the ``numpy.random`` surface over lazy creation exprs (port
of ``spartan_tpu/random.py``).

Every draw is a ``CreationExpr`` of ``expr/ndarray.py`` emitted inside its
region on the mesh's device, from a ``torch.Generator`` seeded by the node:
the module functions take their seeds from the global stream (``seed``
resets it), a :class:`Generator` from a stream of its own, so two
generators with the same seed build the same exprs.  torch cannot
reproduce ``jax.random``'s streams: the draws are held to their
distribution's contract (support, dtype, moments), not to the reference's
values.  ``permutation``, ``shuffle`` and ``choice`` are the argsort of
uniform keys, as in the reference.
"""

from __future__ import annotations

import numpy as np

from spartan_tpu_torch.expr import builtins as _b
from spartan_tpu_torch.expr.ndarray import CreationExpr, _next_seed
from spartan_tpu_torch.expr.ndarray import set_random_seed as seed  # noqa: F401

__all__ = ["seed", "random", "rand", "randn", "standard_normal", "normal",
           "uniform", "randint", "integers", "choice", "permutation",
           "bernoulli"]

rand = _b.rand
randn = _b.randn
randint = _b.randint
choice = _b.choice
permutation = _b.permutation


def _tup(size):
  if isinstance(size, (int, np.integer)):
    return (int(size),)
  return tuple(int(s) for s in size)


def random(size=()):
  """Uniform [0, 1) of the given shape (``np.random.random``)."""
  return _b.rand(*_tup(size))


def standard_normal(size=()):
  return _b.randn(*_tup(size))


def normal(loc=0.0, scale=1.0, size=()):
  return _b.randn(*_tup(size)) * scale + loc


def uniform(low=0.0, high=1.0, size=()):
  return _b.rand(*_tup(size)) * (high - low) + low


def integers(low, high=None, size=()):
  """``np.random.Generator.integers`` (half-open, like ``randint``)."""
  return _b.randint(low, high, size=_tup(size))


def bernoulli(p=0.5, size=()):
  return _b.rand(*_tup(size)) < p


def _dist(op, size, dtype, **params):
  return CreationExpr(op, _tup(size), dtype,
                      {**params, "seed": _next_seed()}, None)


def exponential(scale=1.0, size=()):
  return _dist("exponential", size, np.float64, scale=float(scale))


def poisson(lam=1.0, size=()):
  return _dist("poisson", size, np.int64, lam=float(lam))


def binomial(n, p, size=()):
  return _dist("binomial", size, np.int64, n=float(n), p=float(p))


def beta(a, b, size=()):
  return _dist("beta", size, np.float64, a=float(a), b=float(b))


def gamma(shape, scale=1.0, size=()):
  return _dist("gamma", size, np.float64, shape_param=float(shape),
               scale=float(scale))


def shuffle(v):
  """A shuffled copy along axis 0: lazy arrays are immutable, so this is
  ``permutation(v)``, not NumPy's shuffle in place (the reference's
  choice)."""
  return _b.permutation(v)


__all__ += ["exponential", "poisson", "binomial", "beta", "gamma", "shuffle"]


class Generator:
  """``np.random.Generator``'s object API (``rng =
  sp.random.default_rng(seed)``): each generator owns a deterministic seed
  stream of its own; two generators with the same seed build the same
  exprs."""

  def __init__(self, seed: int = 0):
    self._base = int(seed) * 1_000_003 + 0x9E3779B9
    self._n = 0

  def _next_seed(self) -> int:
    self._n += 1
    return (self._base + self._n * 2_654_435_761) % (1 << 63)

  def _creation(self, op, size, dtype, **params):
    return CreationExpr(op, _tup(size), dtype,
                        {**params, "seed": self._next_seed()}, None)

  def random(self, size=()):
    return self._creation("rand", size, np.float64)

  def uniform(self, low=0.0, high=1.0, size=()):
    return self.random(size) * (high - low) + low

  def standard_normal(self, size=()):
    return self._creation("randn", size, np.float64)

  def normal(self, loc=0.0, scale=1.0, size=()):
    return self.standard_normal(size) * scale + loc

  def integers(self, low, high=None, size=()):
    if high is None:
      low, high = 0, low
    return self._creation("randint", size, np.int64,
                          low=int(low), high=int(high))

  def exponential(self, scale=1.0, size=()):
    return self._creation("exponential", size, np.float64,
                          scale=float(scale))

  def poisson(self, lam=1.0, size=()):
    return self._creation("poisson", size, np.int64, lam=float(lam))

  def binomial(self, n, p, size=()):
    return self._creation("binomial", size, np.int64, n=float(n),
                          p=float(p))

  def beta(self, a, b, size=()):
    return self._creation("beta", size, np.float64, a=float(a), b=float(b))

  def gamma(self, shape, scale=1.0, size=()):
    return self._creation("gamma", size, np.float64,
                          shape_param=float(shape), scale=float(scale))

  def permutation(self, v):
    """The argsort of uniform keys from this generator's stream."""
    if isinstance(v, (int, np.integer)):
      v = _b.arange(int(v))
    v = _b.lazify(v)
    keys = self._creation("rand", (int(v.shape[0]),), np.float64)
    return _b.take(v, _b.argsort(keys), axis=0)

  def shuffle(self, v):
    return self.permutation(v)

  def choice(self, a, size, replace: bool = True):
    if isinstance(a, (int, np.integer)):
      a = _b.arange(int(a))
    a = _b.lazify(a)
    if a.ndim != 1:
      raise ValueError("a must be 1-dimensional")
    n, k = int(a.shape[0]), int(size)
    if replace:
      return _b.take(a, self.integers(0, n, (k,)))
    if k > n:
      raise ValueError("cannot take a larger sample than population when "
                       "replace=False")
    return _b.take(a, self.permutation(n)[:k])


def default_rng(seed: int = 0) -> Generator:
  """``np.random.default_rng``: an independent seeded Generator."""
  return Generator(seed)


__all__ += ["Generator", "default_rng"]


def moments(op: str, **params):
  """``(mean, variance, fourth central moment)`` of distribution ``op``
  with ``params`` (its creation parameters, as in this module's
  signatures): the contract a sample of it is held to."""
  if op == "normal":
    return 0.0, 1.0, 3.0
  if op == "gamma":
    k, s = params["shape"], params.get("scale", 1.0)
    var = k * s * s
    return k * s, var, var * var * (3.0 + 6.0 / k)
  if op == "beta":
    a, b = params["a"], params["b"]
    t = a + b
    var = a * b / (t * t * (t + 1))
    excess = (6 * ((a - b) ** 2 * (t + 1) - a * b * (t + 2))
              / (a * b * (t + 2) * (t + 3)))
    return a / t, var, var * var * (3.0 + excess)
  if op == "poisson":
    lam = params["lam"]
    return lam, lam, lam * lam * (3.0 + 1.0 / lam)
  if op == "binomial":
    n, p = params["n"], params["p"]
    var = n * p * (1 - p)
    return n * p, var, var * var * (3.0 + (1 - 6 * p * (1 - p)) / var)
  if op == "exponential":
    s = params.get("scale", 1.0)
    return s, s * s, 9.0 * s ** 4
  raise ValueError(f"no moments for {op!r}")
