"""``sp.random`` held to its contract: torch cannot reproduce
``jax.random``'s streams (ROADMAP's Watch list, "Random streams"), so each
draw is held to its distribution, not to the reference's values: its shape
and dtype (the reference's), its support, and its first two moments at a
z-bound, with the same surface as the reference's module.

The moment checks: the sample mean of N draws is within Z = 6 standard
errors ``sqrt(var / N)`` of the mean, and the sample variance within Z of
``sqrt((mu4 - var²) / N)`` of the variance (``mu4`` the fourth central
moment, ``sp.random.moments``).  A correct sampler fails one of them with
probability below 4e-9.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp

N = 1 << 17
Z = 6.0


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])
  sp.random.seed(0)


def _held(x: np.ndarray, op: str, **params):
  mean, var, mu4 = sp.random.moments(op, **params)
  x = x.astype(np.float64).ravel()
  n = x.size
  zm = abs(x.mean() - mean) / np.sqrt(var / n)
  zv = abs(x.var() - var) / np.sqrt((mu4 - var * var) / n)
  assert zm < Z and zv < Z, (op, params, zm, zv)


def test_the_surface_is_the_references():
  assert sorted(sp.random.__all__) == sorted(ref.random.__all__)
  for name in ref.random.__all__:
    assert callable(getattr(sp.random, name)), name


CASES = [
    ("gamma", lambda r: r.gamma(2.5, 1.5, size=N), {"shape": 2.5,
                                                    "scale": 1.5}),
    ("gamma", lambda r: r.gamma(0.3, size=N), {"shape": 0.3}),
    ("gamma", lambda r: r.gamma(40.0, size=N), {"shape": 40.0}),
    ("beta", lambda r: r.beta(0.5, 2.0, size=N), {"a": 0.5, "b": 2.0}),
    ("beta", lambda r: r.beta(3.0, 3.0, size=N), {"a": 3.0, "b": 3.0}),
    ("beta", lambda r: r.beta(0.05, 0.08, size=N), {"a": 0.05, "b": 0.08}),
    ("poisson", lambda r: r.poisson(3.0, size=N), {"lam": 3.0}),
    ("poisson", lambda r: r.poisson(250.0, size=N), {"lam": 250.0}),
    ("binomial", lambda r: r.binomial(10, 0.3, size=N), {"n": 10, "p": 0.3}),
    ("binomial", lambda r: r.binomial(1000, 0.02, size=N),
     {"n": 1000, "p": 0.02}),
    ("exponential", lambda r: r.exponential(2.0, size=N), {"scale": 2.0}),
]


@pytest.mark.parametrize("source", ["module", "generator"])
@pytest.mark.parametrize("op,draw,params", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_distributions_hold_their_moments(source, op, draw, params):
  rng = sp.random if source == "module" else sp.random.default_rng(5)
  rrng = ref.random if source == "module" else ref.random.default_rng(5)
  e = draw(rng)
  want = draw(rrng)  # the reference's shape and dtype, not its values
  assert tuple(e.shape) == tuple(want.shape) == (N,)
  x = e.glom()
  assert x.dtype == np.dtype(want.dtype)
  assert np.isfinite(x).all()
  if op in ("gamma", "exponential"):
    assert (x >= 0).all()
  elif op == "beta":
    assert ((x >= 0) & (x <= 1)).all()
  elif op == "binomial":
    assert ((x >= 0) & (x <= params["n"])).all()
  else:
    assert (x >= 0).all()
  _held(x, op, **params)


def test_normal_uniform_and_integers():
  x = sp.random.standard_normal((256, 512)).glom()
  _held(x, "normal")
  y = sp.random.normal(3.0, 2.0, size=N).glom()
  _held((y - 3.0) / 2.0, "normal")
  u = sp.random.uniform(-1.0, 3.0, size=N).glom()
  assert ((u >= -1) & (u < 3)).all()
  assert abs(u.mean() - 1.0) < Z * np.sqrt(16 / 12 / N)
  k = sp.random.integers(3, 9, size=N).glom()
  assert k.dtype == np.int64 and k.min() == 3 and k.max() == 8
  b = sp.random.bernoulli(0.25, size=N).glom()
  assert b.dtype == np.bool_
  assert abs(b.mean() - 0.25) < Z * np.sqrt(0.25 * 0.75 / N)
  r = sp.random.random((3, 4)).glom()
  assert r.shape == (3, 4) and r.dtype == np.float64


def test_streams_are_seeded_and_independent():
  a = sp.random.default_rng(3).gamma(2.0, size=64).glom()
  b = sp.random.default_rng(3).gamma(2.0, size=64).glom()
  c = sp.random.default_rng(4).gamma(2.0, size=64).glom()
  np.testing.assert_array_equal(a, b)
  assert not np.array_equal(a, c)
  g = sp.random.default_rng(3)
  assert not np.array_equal(g.normal(size=64).glom(),
                            g.normal(size=64).glom())
  sp.random.seed(9)
  p = sp.random.poisson(4.0, size=64).glom()
  sp.random.seed(9)
  np.testing.assert_array_equal(sp.random.poisson(4.0, size=64).glom(), p)


def test_permutation_shuffle_choice():
  g = sp.random.default_rng(1)
  p = g.permutation(1000).glom()
  np.testing.assert_array_equal(np.sort(p), np.arange(1000))
  v = np.arange(50.0) * 3
  s = g.shuffle(v).glom()
  np.testing.assert_array_equal(np.sort(s), v)
  c = g.choice(100, 40, replace=False).glom()
  assert len(set(c.tolist())) == 40 and c.min() >= 0 and c.max() < 100
  c2 = g.choice(np.arange(5.0), 200).glom()
  assert set(c2.tolist()) <= set(range(5))
  with pytest.raises(ValueError):
    g.choice(10, 11, replace=False)
  np.testing.assert_array_equal(np.sort(sp.random.shuffle(v).glom()), v)
  np.testing.assert_array_equal(np.sort(sp.random.permutation(30).glom()),
                                np.arange(30))


def test_gamma_needs_a_positive_shape():
  with pytest.raises(ValueError):
    sp.random.gamma(0.0, size=4).glom()


def test_distributions_fuse_into_a_region():
  """A draw is a creation node inside its region: a sum over it plans as
  any other creation does."""
  e = (sp.random.default_rng(2).exponential(1.0, size=(64, 64)) * 2).sum()
  assert np.isfinite(float(e.glom()))
