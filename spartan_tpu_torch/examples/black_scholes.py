"""Black–Scholes European option pricing (port of
``spartan_tpu/examples/black_scholes.py``).  The closed form is one
elementwise chain over the price, strike and expiry arrays, through the
port's ``sp.erf``; ``price_numpy`` is the float64 host oracle.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp

_SQRT2 = float(np.sqrt(2.0))


def _ncdf(x):
  """Standard normal CDF via erf (lazy, fuses into the pricing chain)."""
  return 0.5 * (sp.erf(x / _SQRT2) + 1.0)


def price(spot, strike, t, rate: float = 0.05, vol: float = 0.25):
  """Lazy (call, put) prices for European options.

  All array args may be SpartanArrays/exprs/numpy; scalars broadcast.
  """
  spot, strike, t = sp.lazify(spot), sp.lazify(strike), sp.lazify(t)
  sqrt_t = sp.sqrt(t)
  d1 = (sp.log(spot / strike) + (rate + 0.5 * vol * vol) * t) / (vol * sqrt_t)
  d2 = d1 - vol * sqrt_t
  disc = sp.exp(-rate * t) * strike
  call = spot * _ncdf(d1) - disc * _ncdf(d2)
  put = disc * _ncdf(-d2) - spot * _ncdf(-d1)
  return call, put


def price_numpy(spot, strike, t, rate: float = 0.05, vol: float = 0.25):
  """Host oracle (same closed form in NumPy, f64)."""
  from scipy.special import erf

  spot = np.asarray(spot, np.float64)
  strike = np.asarray(strike, np.float64)
  t = np.asarray(t, np.float64)
  ncdf = lambda x: 0.5 * (erf(x / _SQRT2) + 1.0)  # noqa: E731
  sqrt_t = np.sqrt(t)
  d1 = (np.log(spot / strike) + (rate + 0.5 * vol**2) * t) / (vol * sqrt_t)
  d2 = d1 - vol * sqrt_t
  disc = np.exp(-rate * t) * strike
  return (spot * ncdf(d1) - disc * ncdf(d2),
          disc * ncdf(-d2) - spot * ncdf(-d1))


def run(n: int = 1 << 16, seed: int = 0):
  """Price a random book; returns (call, put) SpartanArrays."""
  rng = np.random.default_rng(seed)
  spot = sp.from_numpy(rng.uniform(10.0, 200.0, n))
  strike = sp.from_numpy(rng.uniform(10.0, 200.0, n))
  t = sp.from_numpy(rng.uniform(0.1, 2.0, n))
  call, put = price(spot, strike, t)
  return call.evaluate(), put.evaluate()
