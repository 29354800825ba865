"""Lazy array creation (port of ``spartan_tpu/expr/ndarray.py``).

Creation emits ``torch.full`` / ``arange`` / ``eye`` / ``linspace`` /
``tri`` / the window functions / ``rand`` / ``randn`` / ``randint`` inside
the region, on the region's device.  ``linspace`` computes NumPy's values
(``i * step + start`` in float64, the last element ``stop``), the windows
NumPy's formulas in float64.  Random creation draws from an explicit
``torch.Generator(device).manual_seed(seed)`` per node, the distributions
of ``sp.random`` (exponential, Poisson, binomial, gamma, beta) too; its
stream differs from the reference's ``jax.random`` one, so parity tests
feed both packages the same data through ``from_numpy`` and hold the draws
to their distribution's contract.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from spartan_tpu_torch.core.array import dtype_kind, to_torch_dtype
from spartan_tpu_torch.expr.base import EmitCtx, Expr

_seed_counter = [0]


def _next_seed() -> int:
  _seed_counter[0] += 1
  return _seed_counter[0]


def set_random_seed(seed: int) -> None:
  """Reset the stream used to derive per-expr generator seeds."""
  _seed_counter[0] = int(seed) * 1_000_003


class CreationExpr(Expr):
  """Materialize-free array construction (zeros/ones/full/arange/rand…)."""

  _members = ()
  _params = ("op", "out_shape", "out_dtype", "params", "tile_hint")

  def __init__(self, op: str, out_shape: Sequence[int], out_dtype,
               params: Optional[Dict[str, Any]] = None,
               tile_hint: Optional[Sequence[int]] = None):
    if op not in ("full", "arange", "eye", "linspace", "tri", "window",
                  "rand", "randn", "randint") + DISTRIBUTIONS:
      raise ValueError(f"unknown creation op {op!r}")
    out_shape = tuple(int(s) for s in out_shape)
    super().__init__(op=op, out_shape=out_shape,
                     out_dtype=to_torch_dtype(out_dtype),
                     params=dict(params or {}), tile_hint=tile_hint)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    op, shape, dt, p = self.op, self.out_shape, self.out_dtype, self.params
    if ctx.abstract:
      return torch.empty(shape, dtype=dt, device="meta")
    dev = ctx.device
    if op == "full":
      return torch.full(shape, p["fill"], dtype=dt, device=dev)
    if op == "arange":
      n = shape[0]
      if all(isinstance(p[k], int) for k in ("start", "stop", "step")):
        vals = torch.arange(p["start"], p["stop"], p["step"],
                            dtype=torch.int64, device=dev)
      else:
        # numpy's values: start + i*step, computed in float64
        vals = p["start"] + p["step"] * torch.arange(
            n, dtype=torch.float64, device=dev)
      return vals.to(dt).reshape(shape)
    if op == "eye":
      rows = torch.arange(shape[0], device=dev)[:, None]
      cols = torch.arange(shape[1], device=dev)[None, :]
      return (cols - rows == p["k"]).to(dt)
    if op == "tri":
      rows = torch.arange(shape[0], device=dev)[:, None]
      cols = torch.arange(shape[1], device=dev)[None, :]
      return (cols - rows <= p["k"]).to(dt)
    if op == "linspace":
      return _linspace(p["start"], p["stop"], shape[0], dev).to(dt)
    if op == "window":
      return _window(p["name"], shape[0], p.get("beta"), dev).to(dt)
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    if op == "randint":
      return torch.randint(p["low"], p["high"], shape, generator=gen,
                           dtype=dt, device=dev)
    if op in DISTRIBUTIONS:
      return _draw(op, p, shape, gen, dev).to(dt)
    if dtype_kind(dt) != "f":
      raise TypeError(f"{op} creates floating arrays, not {dt}")
    if op == "rand":
      return torch.rand(shape, generator=gen, dtype=dt, device=dev)
    return torch.randn(shape, generator=gen, dtype=dt, device=dev)


# The distributions of ``sp.random`` (each a CreationExpr kind), drawn in
# float64 from the node's generator and cast to the node's dtype.
DISTRIBUTIONS = ("exponential", "poisson", "binomial", "beta", "gamma")
# candidate rounds drawn at once for each pending gamma draw; Marsaglia and
# Tsang's test accepts at least 95 % of candidates, so a draw is left
# pending after one pass with probability below 0.05 ** 4
_GAMMA_ROUNDS = 4


def _draw(op: str, p, shape, gen: torch.Generator,
          dev) -> torch.Tensor:
  f64 = torch.float64
  if op == "exponential":
    return torch.empty(shape, dtype=f64, device=dev).exponential_(
        generator=gen) * p["scale"]
  if op == "poisson":
    return torch.poisson(torch.full(shape, p["lam"], dtype=f64, device=dev),
                         generator=gen)
  if op == "binomial":
    return torch.binomial(torch.full(shape, p["n"], dtype=f64, device=dev),
                          torch.full(shape, p["p"], dtype=f64, device=dev),
                          generator=gen)
  n = 1
  for s in shape:
    n *= int(s)
  if op == "gamma":
    return torch.exp(_log_gamma(p["shape_param"], n, gen, dev)).reshape(
        shape) * p["scale"]
  lx = _log_gamma(p["a"], n, gen, dev)
  ly = _log_gamma(p["b"], n, gen, dev)
  return torch.exp(lx - torch.logaddexp(lx, ly)).reshape(shape)


def _log_gamma(a: float, n: int, gen: torch.Generator,
               dev) -> torch.Tensor:
  """log of ``n`` float64 Gamma(a, 1) draws from ``gen``: Marsaglia and
  Tsang's squeeze-free rejection (ACM TOMS 26(3), 2000) for a >= 1; for
  a < 1, Gamma(a + 1) · U^(1/a), kept in logs so that small shapes do not
  underflow.  torch's own gamma sampler takes no generator."""
  a = float(a)
  if not a > 0:
    raise ValueError(f"gamma needs a positive shape, got {a}")
  f64 = torch.float64
  d = (a + 1.0 if a < 1 else a) - 1.0 / 3.0
  c = 1.0 / (9.0 * d) ** 0.5
  out = torch.empty(n, dtype=f64, device=dev)
  pending = torch.arange(n, device=dev)
  while pending.numel():
    k = pending.numel()
    x = torch.randn((_GAMMA_ROUNDS, k), generator=gen, dtype=f64, device=dev)
    u = torch.rand((_GAMMA_ROUNDS, k), generator=gen, dtype=f64, device=dev)
    v = (1.0 + c * x) ** 3
    log_v = torch.log(torch.where(v > 0, v, 1.0))
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    first = ok.to(torch.int32).argmax(0, keepdim=True)
    taken = ok.any(0)
    out[pending[taken]] = (log_v.gather(0, first)[0] + math.log(d))[taken]
    pending = pending[~taken]
  if a < 1:
    u = torch.rand(n, generator=gen, dtype=f64, device=dev)
    out += torch.log(u) / a
  return out


def _linspace(start, stop, num: int, device) -> torch.Tensor:
  """NumPy's ``linspace`` in float64: ``arange(num) * step + start`` with
  ``step = (stop - start) / (num - 1)``, the last element ``stop``
  (torch's own rounds differently)."""
  y = torch.arange(num, dtype=torch.float64, device=device)
  delta = float(stop) - float(start)
  div = num - 1
  if div > 0:
    step = delta / div
    y = y / div * delta if step == 0 else y * step
  else:
    y = y * delta
  y = y + float(start)
  if num > 1:
    y[-1] = float(stop)
  return y


def _window(name: str, m: int, beta, device) -> torch.Tensor:
  """NumPy's window of length ``m`` (its formula, in float64)."""
  if m < 1:
    return torch.zeros(0, dtype=torch.float64, device=device)
  if m == 1:
    return torch.ones(1, dtype=torch.float64, device=device)
  if name == "kaiser":
    n = torch.arange(m, dtype=torch.float64, device=device)
    alpha = (m - 1) / 2.0
    arg = beta * torch.sqrt(1 - ((n - alpha) / alpha) ** 2.0)
    return torch.i0(arg) / torch.i0(torch.tensor(float(beta),
                                                 dtype=torch.float64))
  n = torch.arange(1 - m, m, 2, dtype=torch.float64, device=device)
  if name == "bartlett":
    return torch.where(n <= 0, 1 + n / (m - 1), 1 - n / (m - 1))
  c = torch.cos(torch.pi * n / (m - 1))
  if name == "blackman":
    return 0.42 + 0.5 * c + 0.08 * torch.cos(2.0 * torch.pi * n / (m - 1))
  return {"hamming": 0.54 + 0.46 * c, "hanning": 0.5 + 0.5 * c}[name]
