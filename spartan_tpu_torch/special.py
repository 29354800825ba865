"""``sp.special`` — the scipy.special surface (port of
``spartan_tpu/special.py``).

Special functions are elementwise math, so as much of the namespace as
possible stays on the lazy device path, where it fuses into the
expressions around it:

* **direct core** — every name the reference wraps from
  ``jax.scipy.special`` is a lazy ``sp.map`` of a torch function:
  ``torch.special``'s own where it has one (``gammaln``, ``digamma``,
  ``gammainc``, ``erfinv``, ``i0``, ...), else the algorithm
  ``jax.scipy.special`` uses, written in torch ops (``gamma``, ``ndtr``'s
  erfc form (torch's loses the left tail), ``betainc``'s continued fraction, ``zeta``'s Euler–Maclaurin sum, the
  Cephes exponential integrals, ``hyp1f1``/``hyp2f1``'s series,
  ``spence``, ``sici``, ``fresnel``, Bessel ``J_n``'s backward recurrence,
  ``sph_harm_y``; ``zeta`` and ``erfcx`` also because torch's CUDA forms
  are compiled at their first call, seconds each).  ``erf``,
  ``erfc``, ``log1p``, ``expm1``, ``exp2`` and ``cbrt`` are the port's
  builtins, so they fuse and plan onto the fused-reduce kernel as those do;
* **composition layer** — names scipy implements in Cephes that are exact
  compositions of the core (``cosm1``, ``powm1``, ``exprel``, the degree
  trig family, ``boxcox*``, ``agm`` and the complete elliptic integrals);
* **device inverses** — ``gammaincinv``/``betaincinv``/``kolmogi``/...:
  a fixed count of halvings, independent of the data, so nothing is read
  on the host;
* **distribution-CDF family** — ``stdtr``/``chdtr``/``fdtr``/``pdtr``/
  ``bdtr``/``nbdtr``/``gdtr`` (with the ``*c`` complements and ``*i``
  inverses) as betainc/gammainc identities, and ``kolmogorov``;
* **orthogonal polynomials** — the three-term recurrence, unrolled over the
  static integer degree;
* **host boundary** — every other callable of ``scipy.special`` wraps the
  scipy call on the evaluated inputs, counted in
  ``expr.fio.counts["host_runs"]``; ``_HOST_NAMES`` lists them.

A loop whose length depends on the data (a continued fraction or a series
that stops at convergence, as ``jax``'s ``while_loop`` does under
``vmap``) freezes each element once it has converged and reads on the
host, every 8 turns, whether any element still runs (``counts["reads"]``).

Integer and bool operands become float64, as scipy's; float32 stays
float32.
"""

from __future__ import annotations

import functools
import inspect as _inspect
import math

import numpy as np
import scipy.special as _ss
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.map import structural
from spartan_tpu_torch.util import log_info

_py_callable = callable

# host reads of the converging loops, and their turns
counts = {"reads": 0, "turns": 0}

_EULER = float(np.euler_gamma)
_PI = math.pi
_LN2 = math.log(2.0)
_SQRT2 = math.sqrt(2.0)


def _f(x):
  """Promote integer/bool operands to float64 (scipy's promotion); a float
  tensor keeps its dtype."""
  if not isinstance(x, torch.Tensor):
    x = torch.as_tensor(x, dtype=torch.float64)
  if x.is_floating_point() or x.is_complex():
    return x
  return x.to(torch.float64)


def _lift(x, device):
  """A weak Python scalar as a 0-d tensor on ``device``: torch keeps a 0-d
  operand from widening an n-d one, as jax's weak types do."""
  if isinstance(x, torch.Tensor):
    return x
  if isinstance(x, bool):
    return torch.tensor(x, dtype=torch.bool, device=device)
  if isinstance(x, int):
    return torch.tensor(x, dtype=torch.int64, device=device)
  if isinstance(x, complex):
    return torch.tensor(x, dtype=torch.complex128, device=device)
  return torch.tensor(float(x), dtype=torch.float64, device=device)


def _lifted(kern):
  """``kern`` over tensors only: its weak scalars are lifted onto the device
  of its tensor operands (the mesh's device if it has none)."""
  def op(*xs):
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    device = like.device if like is not None else sp.get_mesh().device
    return kern(*[_lift(x, device) for x in xs])
  op.__name__ = getattr(kern, "__name__", "special")
  op.__qualname__ = op.__name__
  return op


def _mapn(kern, *args):
  return sp.map([sp.lazify(a) for a in args], _lifted(kern))


def _mapn_whole(kern, *args):
  """A map that is not elementwise (a reduction over an axis, an extra
  axis of its own): its inputs stay whole."""
  return sp.map([sp.lazify(a) for a in args], structural(_lifted(kern)))


def _bcast(*xs):
  """``_f`` of each operand, broadcast to one shape and one dtype (a 0-d
  operand does not widen an n-d one)."""
  xs = [_f(x) for x in xs]
  pool = [x for x in xs if x.ndim > 0] or xs
  dt = functools.reduce(torch.promote_types, [x.dtype for x in pool])
  return torch.broadcast_tensors(*[x.to(dt) for x in xs])


def _eps(x) -> float:
  return float(torch.finfo(x.dtype).eps)


def _polyval(coefs, x):
  """Horner's rule, highest power first (``jnp.polyval``)."""
  acc = torch.full_like(x, float(coefs[0]))
  for c in coefs[1:]:
    acc = acc * x + float(c)
  return acc


def _running(active) -> bool:
  """Does any element still iterate?  A host read (none on meta tensors:
  shape inference runs no turn)."""
  if active.is_meta:
    return False
  counts["reads"] += 1
  return bool(active.any())


def _while(cond, body, state, max_iter, need=None):
  """jax's ``while_loop`` under ``vmap``: each element applies ``body`` until
  its ``cond`` fails (or ``max_iter`` turns); ``need`` masks out the
  elements whose result is not used.  Turns go in blocks of 8 between host
  reads."""
  active = cond(*state)
  if need is not None:
    active = active & need
  for k in range(max_iter):
    if k % 8 == 0 and not _running(active):
      break
    counts["turns"] += 1
    new = body(*state)
    state = tuple(torch.where(active, n, s) for n, s in zip(new, state))
    active = active & cond(*state)
  return state


def _masked_max(x, mask, default=0) -> int:
  """``max(x[mask])`` on the host, for a loop bound ``jax`` takes per
  element; ``default`` where nothing is masked in."""
  if x.is_meta:
    return default
  counts["reads"] += 1
  sel = x[mask.expand_as(x)] if mask is not None else x.reshape(-1)
  sel = sel[torch.isfinite(sel)]
  return int(math.ceil(float(sel.max()))) if sel.numel() else default


# ---------------------------------------------------------------------
# the direct core (jax.scipy.special's algorithms in torch ops)
# ---------------------------------------------------------------------

def _gammasgn(x):
  floor_x = torch.floor(x)
  neg = x < 0
  nan = (neg & (x == floor_x)) | torch.isnan(x)
  minus = (neg & (torch.remainder(floor_x, 2) != 0)) | ((x == 0) & torch.signbit(x))
  one = torch.ones_like(x)
  return torch.where(nan, torch.full_like(x, math.nan),
                     torch.where(minus, -one, one))


def _gamma(x):
  return _gammasgn(x) * torch.exp(torch.special.gammaln(x))


def _algdiv(a, b):
  """log(Γ(b)/Γ(a+b)) for b >= 8 (scipy's cdflib ``algdiv``, a <= b)."""
  c0 = 0.833333333333333e-01
  c1 = -0.277777777760991e-02
  c2 = 0.793650666825390e-03
  c3 = -0.595202931351870e-03
  c4 = 0.837308034031215e-03
  c5 = -0.165322962780713e-02
  h = a / b
  c = h / (1 + h)
  x = h / (1 + h)
  d = b + (a - 0.5)
  x2 = x * x
  s3 = 1.0 + (x + x2)
  s5 = 1.0 + (x + x2 * s3)
  s7 = 1.0 + (x + x2 * s5)
  s9 = 1.0 + (x + x2 * s7)
  s11 = 1.0 + (x + x2 * s9)
  t = (1.0 / b) ** 2
  w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t
       + c1 * s3) * t + c0
  w = w * (c / b)
  u = d * torch.log1p(a / b)
  v = a * (torch.log(b) - 1.0)
  return torch.where(u <= v, (w - v) - u, (w - u) - v)


def _betaln(a, b):
  a, b = _bcast(a, b)
  a, b = torch.minimum(a, b), torch.maximum(a, b)
  lg = torch.special.gammaln
  small_b = lg(a) + (lg(b) - lg(a + b))
  large_b = lg(a) + _algdiv(a, b)
  return torch.where(b < 8, small_b, large_b)


def _beta(a, b):
  a, b = _bcast(a, b)
  sign = _gammasgn(a) * _gammasgn(b) * _gammasgn(a + b)
  return sign * torch.exp(_betaln(a, b))


def _betainc(a, b, x):
  """The regularized incomplete beta function by its continued fraction
  (DLMF 8.17.22), evaluated by the modified Lentz algorithm, with the
  symmetry I_x(a, b) = 1 - I_{1-x}(b, a) where it converges slowly
  (XLA's ``RegularizedIncompleteBeta``, which ``jax`` lowers to)."""
  a, b, x = _bcast(a, b, x)
  dt = x.dtype
  eps = _eps(x)
  small = eps / 2
  threshold = eps / 2
  num_iterations = 200 if dt == torch.float32 else 600
  inf = math.inf
  a_is_zero = (a == 0) | (b == inf)
  b_is_zero = (b == 0) | (a == inf)
  x_is_zero = x == 0
  x_is_one = x == 1
  is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
  result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
  result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
  result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                   | (a_is_zero & b_is_zero) | is_nan)
  rapid = x < (a + 1) / (a + b + 2.0)
  a, b, x = (torch.where(rapid, a, b), torch.where(rapid, b, a),
             torch.where(rapid, x, 1 - x))

  def numerator(it):
    if it == 1:
      return torch.ones_like(x)
    m = (it - 1) // 2
    if it % 2 == 0:
      if m == 0:
        return -(a + b) * x / (a + 1)
      return -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
    return m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))

  # partial denominator 0 at iteration 0 -> h starts at ``small``
  h = torch.full_like(x, small)
  c = h
  d = torch.zeros_like(x)
  active = torch.ones_like(x, dtype=torch.bool)
  for it in range(1, num_iterations):
    if (it - 1) % 8 == 0 and not _running(active):
      break
    counts["turns"] += 1
    pn = numerator(it)
    cn = 1.0 + pn / c
    cn = torch.where(torch.abs(cn) < small, small, cn)
    dn = 1.0 + pn * d
    dn = torch.where(torch.abs(dn) < small, small, dn)
    dn = 1.0 / dn
    delta = cn * dn
    c = torch.where(active, cn, c)
    d = torch.where(active, dn, d)
    h = torch.where(active, h * delta, h)
    active = active & (torch.abs(delta - 1.0) >= threshold)
  very_small = float(torch.finfo(dt).tiny) * 2
  lg = torch.special.gammaln
  lbeta_small_a = lg(b) - lg(a + b)
  lbeta = lg(a) + lbeta_small_a
  factor = torch.where(a < very_small,
                       torch.exp(torch.log1p(-x) * b - lbeta_small_a),
                       torch.exp(torch.log(x) * a + torch.log1p(-x) * b
                                 - lbeta) / a)
  result = h * factor
  result = torch.where(rapid, result, 1 - result)
  result = torch.where(result_is_zero, 0.0, result)
  result = torch.where(result_is_one, 1.0, result)
  return torch.where(result_is_nan, math.nan, result)


def _ndtr(x):
  """The standard normal CDF in jax's form: ``(1 + erf(x/√2)) / 2`` near
  0, else ``erfc(|x|/√2) / 2`` (or one minus it), relative-exact in the
  left tail.  torch's ``special.ndtr``, on the CPU and on the card, loses
  that tail (2.5e-8 relative at x = -6, 0 below x ≈ -8.3)."""
  w = x * (0.5 * _SQRT2)
  z = torch.abs(w)
  y = torch.where(z < 0.5 * _SQRT2, 1.0 + torch.special.erf(w),
                  torch.where(w > 0, 2.0 - torch.special.erfc(z),
                              torch.special.erfc(z)))
  return 0.5 * y


def _gammainc(a, x):
  a, x = _bcast(a, x)
  return torch.special.gammainc(a, x)


def _gammaincc(a, x):
  a, x = _bcast(a, x)
  return torch.special.gammaincc(a, x)


def _xlogx(x):
  return torch.where(x == 0, torch.zeros_like(x), x * torch.log(x))


def _entr(x):
  return torch.where(x < 0, -math.inf, -_xlogx(x))


def _rel_entr(p, q):
  p, q = _bcast(p, q)
  both = (p > 0) & (q > 0)
  one_zero = (p == 0) & (q >= 0)
  sp_ = torch.where(both, p, 1.0)
  sq = torch.where(both, q, 1.0)
  val = _xlogx(sp_) - torch.special.xlogy(sp_, sq)
  return torch.where(both, val, torch.where(one_zero, 0.0, math.inf))


def _kl_div(p, q):
  p, q = _bcast(p, q)
  return _rel_entr(p, q) - p + q


# (2k)! / B_2k, the Bernoulli numbers' coefficients of the Euler–Maclaurin
# tail (jax's ``_BERNOULLI_COEFS``)
_BERNOULLI = [12, -720, 30240, -1209600, 47900160, -1307674368000 / 691,
              74724249600, -10670622842880000 / 3617,
              5109094217170944000 / 43867,
              -802857662698291200000 / 174611,
              14101100039391805440000 / 77683,
              -1693824136731743669452800000 / 236364091,
              186134520519971831808000000 / 657931,
              -37893265687455865519472640000000 / 3392780147,
              759790291646040068357842010112000000 / 1723168255201,
              -134196726836183700385281186201600000000 / 7709321041217]


def _zeta(x, q):
  """Hurwitz ζ(s, a) by Euler–Maclaurin summation: N terms, the integral
  of the rest and M Bernoulli corrections at a + N, N = M = 16 (8 in
  float32) (jax's series expansion, after Johansson, Numer. Algorithms
  69(2), 2015, eq. 5).  torch's CUDA zeta compiles at its first call."""
  s, a = _bcast(x, q)
  n = 16 if s.dtype == torch.float64 else 8
  total = torch.zeros_like(s)
  for k in range(n):
    total = total + (a + k) ** -s
  an = a + n
  total = total + an ** (1 - s) / (s - 1)
  prod = torch.ones_like(s)
  tail = torch.zeros_like(s)
  big = float(torch.finfo(s.dtype).max)
  for m in range(2 * n):
    prod = prod * (s + m) / an
    if m % 2 == 0:
      tail = tail + torch.clamp(prod, max=big) / _BERNOULLI[m // 2]
  return total + an ** -s * (0.5 + tail)


def _polygamma(n, x):
  """ψ⁽ⁿ⁾(x) = (-1)ⁿ⁺¹ n! ζ(n+1, x) for n >= 1, digamma for n = 0 (scipy's
  own formula), elementwise in an array ``n``."""
  n, x = _bcast(n, x)
  fac = torch.where(torch.remainder(n + 1, 2) == 0, 1.0, -1.0) * torch.exp(
      torch.special.gammaln(n + 1))
  nz = torch.where(n == 0, torch.ones_like(n), n)
  return torch.where(n == 0, torch.special.digamma(x),
                     fac * _zeta(nz + 1, x))


# Cephes' exponential-integral rational approximations (``ei.c``), as
# jax carries them: (numerator, denominator) on each interval of x > 0
_EXPINT1 = ([-5.350447357812542947283e0, 2.185049168816613393830e2,
             -4.176572384826693777058e3, 5.541176756393557601232e4,
             -3.313381331178144034309e5, 1.592627163384945414220e6],
            [1.0, -5.250547959112862969197e1, 1.259616186786790571525e3,
             -1.756549581973534652631e4, 1.493062117002725991967e5,
             -7.294949239640527645655e5, 1.592627163384945429726e6])
_EXPINT_K = [
    # 2 <= x < 4
    ([1.981808503259689673238e-2, -1.271645625984917501326e0,
      -2.088160335681228318920e0, 2.755544509187936721172e0,
      -4.409507048701600257171e-1, 4.665623805935891391017e-2,
      -1.545042679673485262580e-3, 7.059980605299617478514e-5],
     [1.0, 1.476498670914921440652e0, 5.629177174822436244827e-1,
      1.699017897879307263248e-1, 2.291647179034212017463e-2,
      4.450150439728752875043e-3, 1.727439612206521482874e-4,
      3.953167195549672482304e-5]),
    # 4 <= x <= 8
    ([-1.373215375871208729803e0, -7.084559133740838761406e-1,
      1.580806855547941010501e0, -2.601500427425622944234e-1,
      2.994674694113713763365e-2, -1.038086040188744005513e-3,
      4.371064420753005429514e-5, 2.141783679522602903795e-6],
     [1.0, 8.585231423622028380768e-1, 4.483285822873995129957e-1,
      7.687932158124475434091e-2, 2.449868241021887685904e-2,
      8.832165941927796567926e-4, 4.590952299511353531215e-4,
      -4.729848351866523044863e-6, 2.665195537390710170105e-6]),
    # 8 <= x <= 16
    ([-2.106934601691916512584e0, 1.732733869664688041885e0,
      -2.423619178935841904839e-1, 2.322724180937565842585e-2,
      2.372880440493179832059e-4, -8.343219561192552752335e-5,
      1.363408795605250394881e-5, -3.655412321999253963714e-7,
      1.464941733975961318456e-8, 6.176407863710360207074e-10],
     [1.0, -2.298062239901678075778e-1, 1.105077041474037862347e-1,
      -1.566542966630792353556e-2, 2.761106850817352773874e-3,
      -2.089148012284048449115e-4, 1.708528938807675304186e-5,
      -4.459311796356686423199e-7, 1.394634930353847498145e-8,
      6.150865933977338354138e-10]),
    # 16 <= x <= 32
    ([-2.458119367674020323359e-1, -1.483382253322077687183e-1,
      7.248291795735551591813e-2, -1.348315687380940523823e-2,
      1.342775069788636972294e-3, -7.942465637159712264564e-5,
      2.644179518984235952241e-6, -4.239473659313765177195e-8],
     [1.0, -1.044225908443871106315e-1, -2.676453128101402655055e-1,
      9.695000254621984627876e-2, -1.601745692712991078208e-2,
      1.496414899205908021882e-3, -8.462452563778485013756e-5,
      2.728938403476726394024e-6, -4.239462431819542051337e-8]),
    # 32 <= x <= 64
    ([1.212561118105456670844e-1, -5.823133179043894485122e-1,
      2.348887314557016779211e-1, -3.040034318113248237280e-2,
      1.510082146865190661777e-3, -2.523137095499571377122e-5],
     [1.0, -1.002252150365854016662e0, 2.928709694872224144953e-1,
      -3.337004338674007801307e-2, 1.560544881127388842819e-3,
      -2.523137093603234562648e-5]),
    # x > 64
    ([-7.657847078286127362028e-1, 6.886192415566705051750e-1,
      -2.132598113545206124553e-1, 3.346107552384193813594e-2,
      -3.076541477344756050249e-3, 1.747119316454907477380e-4,
      -6.103711682274170530369e-6, 1.218032765428652199087e-7,
      -1.086076102793290233007e-9],
     [1.0, -1.888802868662308731041e0, 1.066691687211408896850e0,
      -2.751915982306380647738e-1, 3.930852688233823569726e-2,
      -3.414684558602365085394e-3, 1.866844370703555398195e-4,
      -6.345146083130515357861e-6, 1.239754287483206878024e-7,
      -1.086076102793126632978e-9]),
]


def _expi_pos(x):
  """Ei(x) for x >= 0, piecewise on (0, 2], (2, 4], ..., (64, inf)."""
  xs = torch.where(x > 0, x, 1.0)
  num, den = _EXPINT1
  out = torch.where(
      x <= 2,
      xs * _polyval(num, xs) / _polyval(den, xs) + _EULER + torch.log(xs),
      torch.zeros_like(x))
  w = 1.0 / xs
  for i, (num, den) in enumerate(_EXPINT_K, start=1):
    lo = 2.0 ** i
    hi = 2.0 ** (i + 1) if i < 6 else math.inf
    f = w * (_polyval(num, w) / _polyval(den, w)) + 1.0
    out = torch.where((x > lo) & (x <= hi), torch.exp(xs) * w * f, out)
  return torch.where(x == 0, -math.inf, out)


def _expn1(x, n, need):
  """E_n(x) by its power series, x <= 1 (Cephes ``expn``)."""
  eps = _eps(x)
  xs = torch.where(x > 0, x, 1.0)
  psi = -_EULER - torch.log(xs)
  for i in range(1, _masked_max(n, need)):
    psi = torch.where(i < n, psi + 1.0 / i, psi)
  one = torch.ones_like(x)
  n1 = torch.where(n == 1, 2.0 * one, n)
  z = -x
  ans0 = torch.where(n == 1, torch.zeros_like(x), 1.0 / (1.0 - n1))

  def cond(xk, yk, pk, ans, t):
    return (x > 0) & (t > eps)

  def body(xk, yk, pk, ans, t):
    xk = xk + 1.0
    yk = yk * z / xk
    pk = pk + 1.0
    ans = ans + torch.where(pk != 0, yk / pk, 0.0)
    t = torch.where(ans != 0, torch.abs(yk / ans), 1.0)
    return xk, yk, pk, ans, t

  _, _, _, ans, _ = _while(
      cond, body, (torch.zeros_like(x), one, 1.0 - n, ans0,
                   torch.full_like(x, math.inf)), 100000, need)
  return z ** (n - 1.0) * psi / torch.exp(torch.special.gammaln(n)) - ans


def _expn2(x, n, need):
  """E_n(x) by its continued fraction, x > 1 (Cephes ``expn``)."""
  big = 1.44115188075855872e17
  eps = _eps(x)
  one = torch.ones_like(x)

  def cond(k, pkm2, qkm2, pkm1, qkm1, ans, t, r):
    return (x > 0) & (t > eps)

  def body(k, pkm2, qkm2, pkm1, qkm1, ans, t, r):
    k = k + 1.0
    odd = torch.remainder(k, 2) == 1
    yk = torch.where(odd, one, x)
    xk = torch.where(odd, n + (k - 1.0) / 2.0, k / 2.0)
    pk = pkm1 * yk + pkm2 * xk
    qk = qkm1 * yk + qkm2 * xk
    nz = qk != 0
    r = torch.where(nz, pk / torch.where(nz, qk, 1.0), r)
    t = torch.where(nz, torch.abs((ans - r) / r), one)
    ans = torch.where(nz, r, ans)
    pkm2, pkm1, qkm2, qkm1 = pkm1, pk, qkm1, qk
    is_big = torch.abs(pk) > big
    pkm2, pkm1, qkm2, qkm1 = (torch.where(is_big, v / big, v)
                              for v in (pkm2, pkm1, qkm2, qkm1))
    return k, pkm2, qkm2, pkm1, qkm1, ans, t, r

  init = (one, one, x, one, x + n, 1.0 / (x + n),
          torch.full_like(x, math.inf), torch.zeros_like(x))
  ans = _while(cond, body, init, 100000, need)[5]
  return ans * torch.exp(-x)


def _expn3(x, n):
  """E_n(x) by its asymptotic expansion in n, n >= 5000."""
  xk = x + n
  yk = 1.0 / (xk * xk)
  t = n
  ans = yk * t * (6.0 * x * x - 8.0 * t * x + t * t)
  ans = yk * (ans + t * (t - 2.0 * x))
  ans = yk * (ans + t)
  return (ans + 1.0) * torch.exp(-x) / xk


def _expn(n, x):
  n, x = _bcast(n, x)
  c_nan = (n < 0) | (x < 0)
  c_inf = (x == 0) & (n < 2)
  c_zero = (x == 0) & (n >= 2)
  c_n0 = (n == 0) & (x >= 0)
  c_big = n >= 5000
  c_gt1 = x > 1
  conds = [c_nan, c_inf, c_zero, c_n0, c_big, c_gt1]
  taken = torch.zeros_like(x, dtype=torch.bool)
  firsts = []
  for c in conds:
    firsts.append(c & ~taken)
    taken = taken | c
  rest = ~taken
  xs = torch.where(x > 0, x, 1.0)
  ns = torch.where(c_big | c_nan, 1.0, n)
  n1 = torch.where(n == 1, n + n, n)
  out = torch.where(rest, _expn1(x, ns, rest), torch.zeros_like(x))
  out = torch.where(firsts[5], _expn2(xs, ns, firsts[5]), out)
  out = torch.where(firsts[4], _expn3(x, n), out)
  out = torch.where(firsts[3], torch.exp(-x) / xs, out)
  out = torch.where(firsts[2], 1.0 / n1, out)
  out = torch.where(firsts[1], math.inf, out)
  return torch.where(firsts[0], math.nan, out)


def _exp1(x):
  return _expn(torch.ones_like(_f(x)), x)


def _expi(x):
  x = _f(x)
  neg = -_exp1(torch.where(x < 0, -x, 1.0))
  return torch.where(x < 0, neg, _expi_pos(torch.where(x < 0, 0.0, x)))


_SPENCE_A = [4.65128586073990045278E-5, 7.31589045238094711071E-3,
             1.33847639578309018650E-1, 8.79691311754530315341E-1,
             2.71149851196553469920E0, 4.25697156008121755724E0,
             3.29771340985225106936E0, 1.00000000000000000126E0]
_SPENCE_B = [6.90990488912553276999E-4, 2.54043763932544379113E-2,
             2.82974860602568089943E-1, 1.41172597751831069617E0,
             3.63800533345137075418E0, 5.03278880143316990390E0,
             3.54771340985225096217E0, 9.99999999999999998740E-1]


def _spence(x):
  """Dilogarithm (Cephes ``spence``)."""
  x = _f(x)
  xs = torch.where(x > 0, x, 1.0)
  x2 = xs > 2.0
  xx = torch.where(x2, 1.0 / xs, xs)
  x15 = xx > 1.5
  x05 = xx < 0.5
  x2 = x2 | x15
  w = torch.where(x15, 1.0 / xx - 1.0, torch.where(x05, -xx, xx - 1.0))
  y = -w * _polyval(_SPENCE_A, w) / _polyval(_SPENCE_B, w)
  y = torch.where(x05, _PI ** 2 / 6.0 - torch.log(xx) * torch.log(1.0 - xx)
                  - y, y)
  y = torch.where(x2, -0.5 * torch.log(xx) ** 2 - y, y)
  y = torch.where(x == 0.0, _PI ** 2 / 6, y)
  y = torch.where(x == 1.0, 0.0, y)
  return torch.where(x < 0.0, math.nan, y)


def _poch(z, m):
  z, m = _bcast(z, m)
  return torch.where(m == 0.0, torch.ones_like(z), _gamma(z + m) / _gamma(z))


def _hyp1f1(a, b, x):
  """Kummer's ₁F₁ by its power series for |x| < 100 and its asymptotic
  series beyond (jax's, after arXiv:1407.7786)."""
  a, b, x = _bcast(a, b, x)
  eps = _eps(x)
  near = torch.abs(x) < 100

  def cond(serie, k, term):
    return (k < 250) & (torch.abs(term) / torch.abs(serie) > eps)

  def body_s(serie, k, term):
    return serie + term, k + 1, term * ((a + k) / (b + k) * x / (k + 1))

  one = torch.ones_like(x)
  serie = _while(cond, body_s, (one, one, a / b * x), 250, near)[0]
  xa = torch.where(near, 1.0, x)

  def body_a(serie, k, term):
    return (serie + term, k + 1,
            term * ((b - a + k) * (1 - a + k) / (k + 1) / xa))

  asym = _while(cond, body_a, (one, one, (b - a) * (1 - a) / xa), 250,
                ~near)[0]
  asym = _gamma(b) / _gamma(a) * torch.exp(xa) * xa ** (a - b) * asym
  result = torch.where(near, serie, asym)
  result = torch.where((b == 0) & (a != 0), math.inf, result)
  result = torch.where((a == b) & (a != 0), torch.exp(x), result)
  return torch.where(a == 0, 1.0, result)


def _hyp2f1_terminal(a, b, c, x, need):
  eps = _eps(x) * 50
  ib = torch.round(b)
  mask = (b < a) & (torch.abs(b - ib) < eps) & ~(
      (torch.remainder(c, 1) == 0) & (c <= 0) & (c > b))
  a, b = torch.where(mask, b, a), torch.where(mask, a, b)
  a = torch.abs(a)
  serie = torch.ones_like(x)
  term = torch.ones_like(x)
  for i in range(1, _masked_max(a, need) + 1):
    on = i < a + 1
    t = term * (-(a - i + 1) / (c + i - 1) * (b + i - 1) / i * x)
    term = torch.where(on, t, term)
    serie = torch.where(on, serie + t, serie)
  return serie


def _hyp2f1_serie(a, b, c, x, need):
  eps = _eps(x)

  def cond(serie, k, term):
    return (k < 250) & (torch.abs(term) > eps * torch.abs(serie))

  def body(serie, k, term):
    return (serie + term, k + 1,
            term * ((a + k - 1) * (b + k - 1) / (c + k - 1) / k * x))

  zero = torch.zeros_like(x)
  return _while(cond, body, (zero, zero + 1, zero + 1), 250, need)[0]


def _hyp2f1_digamma_transform(a, b, c, x, need):
  eps = _eps(x)
  dg = torch.special.digamma
  d = c - a - b
  s = 1 - x
  rd = torch.round(d)
  e = torch.where(rd >= 0, d, -d)
  d1 = torch.where(rd >= 0, d, 0.0)
  d2 = torch.where(rd >= 0, 0.0, d)
  ard = torch.where(rd >= 0, rd, -rd)
  ax = torch.log(s)
  one = torch.ones_like(x)
  y = dg(one) + dg(1.0 + e) - dg(a + d1) - dg(b + d1) - ax
  y = y / _gamma(e + 1.0)
  p = (a + d1) * (b + d1) * s / _gamma(e + 2.0)

  def cond(p, q, t, y):
    return (t < 250) & (torch.abs(q) >= eps * torch.abs(y))

  def body(p, q, t, y):
    r = (dg(1.0 + t) + dg(1.0 + t + e) - dg(a + t + d1) - dg(b + t + d1)
         - ax)
    q = p * r
    y = y + q
    p = p * (s * (a + t + d1) / (t + 1.0))
    p = p * ((b + t + d1) / (t + 1.0 + e))
    return p, q, t + 1.0, y

  _, _, _, y = _while(cond, body, (p, y, one, y), 250, need)
  # the finite sum of the other half (jax's ``compute_sum``)
  y1 = torch.ones_like(x)
  t = torch.zeros_like(x)
  p = torch.ones_like(x)
  for i in range(1, _masked_max(ard, need & (rd != 0))):
    on = i < ard
    r = 1.0 - e + t
    pn = p * (s * (a + t + d2) * (b + t + d2) / r) / (t + 1.0)
    p = torch.where(on, pn, p)
    t = torch.where(on, t + 1.0, t)
    y1 = torch.where(on, y1 + pn, y1)
  pc = _gamma(c)
  y1 = y1 * (_gamma(e) * pc / (_gamma(a + d1) * _gamma(b + d1)))
  ys = y * (pc / (_gamma(a + d2) * _gamma(b + d2)))
  ys = torch.where(torch.remainder(ard, 2) != 0, -ys, ys)
  q = s ** rd
  summed = torch.where(rd > 0, ys * q + y1, ys + y1 * q)
  return torch.where(rd == 0, y * pc / (_gamma(a) * _gamma(b)), summed)


def _hyp2f1_terminal_or_serie(a, b, c, x, need):
  eps = _eps(x) * 50
  d = c - a - b
  neg_int_a = (a <= 0) & (torch.abs(a - torch.round(a)) < eps)
  neg_int_b = (b <= 0) & (torch.abs(b - torch.round(b)) < eps)
  neg_int = neg_int_a | neg_int_b
  near_one = (x > 0.9) & ~neg_int
  transform = near_one & ~(torch.abs(d - torch.round(d)) >= eps)
  terminal = ~near_one & neg_int
  serie = ~(transform | terminal)
  out = torch.where(serie & need, _hyp2f1_serie(a, b, c, x, serie & need),
                    torch.zeros_like(x))
  if _running(transform & need):
    out = torch.where(transform, _hyp2f1_digamma_transform(
        a, b, c, torch.where(transform, x, 0.5), transform & need), out)
  if _running(terminal & need):
    out = torch.where(terminal, _hyp2f1_terminal(a, b, c, x,
                                                 terminal & need), out)
  return out


def _hyp2f1(a, b, c, x):
  """Gauss's ₂F₁ (jax's, after arXiv:1407.7786)."""
  a, b, c, x = _bcast(a, b, c, x)
  d = c - a - b
  s = 1 - x
  ca = c - a
  cb = c - b
  eps = _eps(x) * 50
  idd = torch.round(d)
  i0 = (x == 0) | (((a == 0) | (b == 0)) & (c != 0))
  i1 = (c == 0) | ((c < 0) & (torch.remainder(c, 1) == 0))
  i2 = (d <= -1) & ~((torch.abs(d - idd) >= eps) & (s < 0))
  i1b = (d <= 0) & (x == 1)
  i3 = (x < 1) & (b == c)
  i4 = (x < 1) & (a == c)
  i1c = x > 1
  i5 = x == 1
  order = [(i0, 0), (i1, 1), (i2, 2), (i1b, 1), (i3, 3), (i4, 4), (i1c, 1),
           (i5, 5)]
  index = torch.full_like(x, 6.0)
  taken = torch.zeros_like(x, dtype=torch.bool)
  for cnd, k in order:
    index = torch.where(cnd & ~taken, float(k), index)
    taken = taken | cnd
  need2 = index == 2
  need6 = index == 6
  out = torch.where(need6, _hyp2f1_terminal_or_serie(a, b, c, x, need6),
                    torch.zeros_like(x))
  if _running(need2):
    out = torch.where(need2, s ** d * _hyp2f1_terminal_or_serie(
        ca, cb, c, x, need2), out)
  out = torch.where(index == 5, _gamma(c) * _gamma(d)
                    / (_gamma(ca) * _gamma(cb)), out)
  out = torch.where(index == 4, s ** (-b), out)
  out = torch.where(index == 3, s ** (-a), out)
  out = torch.where(index == 1, math.inf, out)
  return torch.where(index == 0, 1.0, out)


_DIRECT = {
    # name: (torch function, nargs)
    "gamma": (_gamma, 1), "gammaln": (torch.special.gammaln, 1),
    "gammasgn": (_gammasgn, 1), "digamma": (torch.special.digamma, 1),
    "psi": (torch.special.digamma, 1),
    "gammainc": (_gammainc, 2), "gammaincc": (_gammaincc, 2),
    "beta": (_beta, 2), "betaln": (_betaln, 2),
    "betainc": (_betainc, 3),
    "erfinv": (torch.special.erfinv, 1),
    "ndtr": (_ndtr, 1), "ndtri": (torch.special.ndtri, 1),
    "log_ndtr": (torch.special.log_ndtr, 1),
    "expit": (torch.special.expit, 1), "logit": (torch.special.logit, 1),
    "entr": (_entr, 1), "rel_entr": (_rel_entr, 2),
    "kl_div": (_kl_div, 2),
    "xlogy": (torch.special.xlogy, 2), "xlog1py": (torch.special.xlog1py, 2),
    "exp1": (_exp1, 1), "expi": (_expi, 1),
    "expn": (_expn, 2),
    "i0": (torch.special.i0, 1), "i0e": (torch.special.i0e, 1),
    "i1": (torch.special.i1, 1), "i1e": (torch.special.i1e, 1),
    "zeta": (_zeta, 2),
    "poch": (_poch, 2),
    "hyp1f1": (_hyp1f1, 3), "hyp2f1": (_hyp2f1, 4),
    "spence": (_spence, 1),
    "polygamma": (_polygamma, 2),
}


def _direct(fn, name, nargs, doc):
  def kern(*xs):
    return fn(*[_f(x) for x in xs])
  kern.__name__ = name

  def op(*args):
    if len(args) != nargs:
      raise TypeError(f"{name}() takes {nargs} arguments ({len(args)} given)")
    return _mapn(kern, *args)
  op.__name__ = name
  op.__doc__ = doc
  return op


for _n, (_fn, _na) in _DIRECT.items():
  globals()[_n] = _direct(_fn, _n, _na,
                          f"Lazy elementwise scipy.special.{_n}.")

# the port's builtins: they fuse, and plan onto the fused-reduce kernel
# (an integer operand becomes float64, as ``_f`` does)
erf = sp.erf
erfc = sp.erfc


def multigammaln(a, d):
  """Log multivariate gamma; ``d`` is a static int (jax's contract, which
  checks no domain)."""
  d = int(d)

  def kern(aa):
    aa = _f(aa)
    out = torch.zeros_like(aa)
    for j in range(d):
      out = out + torch.special.gammaln(aa - j / 2.0)
    return out + 0.25 * d * (d - 1) * math.log(_PI)
  return _mapn(kern, a)


def _dims(x, axis):
  if axis is None:
    return tuple(range(x.ndim))
  return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def logsumexp(a, axis=None, b=None, keepdims=False, return_sign=False):
  """Lazy logsumexp (scipy's semantics: ``b`` scales each term, a negative
  sum is nan unless ``return_sign``, which gives ``(value, sign)``)."""
  ops = [sp.lazify(a)] + ([sp.lazify(b)] if b is not None else [])

  def kern(aa, *bb):
    aa = _f(aa)
    if bb:
      aa, bw = _bcast(aa, bb[0])
      aa = torch.where(bw != 0, aa, -math.inf)
    dims = _dims(aa, axis)
    if aa.ndim == 0:
      amax = aa
    else:
      amax = torch.amax(aa, dim=dims, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    ea = torch.exp(aa - amax)
    if bb:
      ea = ea * bw
    sumexp = torch.sum(ea, dim=dims, keepdim=True) if aa.ndim else ea
    sign = torch.sign(sumexp)
    out = torch.log(torch.abs(sumexp)) + amax
    if not keepdims and aa.ndim:
      out = out.squeeze(dims)
      sign = sign.squeeze(dims)
    if return_sign:
      return out, sign
    if bb:
      out = torch.where(sign < 0, math.nan, out)
    return out

  if not return_sign:
    return sp.map(ops, structural(_lifted(kern)))
  return (sp.map(ops, structural(_lifted(lambda *xs: kern(*xs)[0]))),
          sp.map(ops, structural(_lifted(lambda *xs: kern(*xs)[1]))))


def softmax(x, axis=None):
  """Lazy softmax along ``axis`` (all axes for None)."""
  def kern(xx):
    xx = _f(xx)
    dims = _dims(xx, axis)
    if xx.ndim == 0:
      return torch.ones_like(xx)
    un = torch.exp(xx - torch.amax(xx, dim=dims, keepdim=True))
    return un / torch.sum(un, dim=dims, keepdim=True)
  return _mapn_whole(kern, x)


def log_softmax(x, axis=None):
  """Lazy log_softmax along ``axis`` (all axes for None)."""
  def kern(xx):
    xx = _f(xx)
    dims = _dims(xx, axis)
    if xx.ndim == 0:
      return torch.zeros_like(xx)
    sh = xx - torch.amax(xx, dim=dims, keepdim=True)
    return sh - torch.log(torch.sum(torch.exp(sh), dim=dims, keepdim=True))
  return _mapn_whole(kern, x)


_FRESNEL64 = dict(
    sn=[-2.99181919401019853726e3, 7.08840045257738576863e5,
        -6.29741486205862506537e7, 2.54890880573376359104e9,
        -4.42979518059697779103e10, 3.18016297876567817986e11],
    sd=[1.00000000000000000000e0, 2.81376268889994315696e2,
        4.55847810806532581675e4, 5.17343888770096400730e6,
        4.19320245898111231129e8, 2.24411795645340920940e10,
        6.07366389490084639049e11],
    cn=[-4.98843114573573548651e-8, 9.50428062829859605134e-6,
        -6.45191435683965050962e-4, 1.88843319396703850064e-2,
        -2.05525900955013891793e-1, 9.99999999999999998822e-1],
    cd=[3.99982968972495980367e-12, 9.15439215774657478799e-10,
        1.25001862479598821474e-7, 1.22262789024179030997e-5,
        8.68029542941784300606e-4, 4.12142090722199792936e-2,
        1.00000000000000000118e0],
    fn=[4.21543555043677546506e-1, 1.43407919780758885261e-1,
        1.15220955073585758835e-2, 3.45017939782574027900e-4,
        4.63613749287867322088e-6, 3.05568983790257605827e-8,
        1.02304514164907233465e-10, 1.72010743268161828879e-13,
        1.34283276233062758925e-16, 3.76329711269987889006e-20],
    fd=[1.00000000000000000000e0, 7.51586398353378947175e-1,
        1.16888925859191382142e-1, 6.44051526508858611005e-3,
        1.55934409164153020873e-4, 1.84627567348930545870e-6,
        1.12699224763999035261e-8, 3.60140029589371370404e-11,
        5.88754533621578410010e-14, 4.52001434074129701496e-17,
        1.25443237090011264384e-20],
    gn=[5.04442073643383265887e-1, 1.97102833525523411709e-1,
        1.87648584092575249293e-2, 6.84079380915393090172e-4,
        1.15138826111884280931e-5, 9.82852443688422223854e-8,
        4.45344415861750144738e-10, 1.08268041139020870318e-12,
        1.37555460633261799868e-15, 8.36354435630677421531e-19,
        1.86958710162783235106e-22],
    gd=[1.00000000000000000000e0, 1.47495759925128324529e0,
        3.37748989120019970451e-1, 2.53603741420338795122e-2,
        8.14679107184306179049e-4, 1.27545075667729118702e-5,
        1.04314589657571990585e-7, 4.60680728146520428211e-10,
        1.10273215066240270757e-12, 1.38796531259578871258e-15,
        8.39158816283118707363e-19, 1.86958710162783236342e-22])
_FRESNEL32 = dict(
    sn=[1.647629463788700e-9, -1.522754752581096e-7, 8.424748808502400e-6,
        -3.120693124703272e-4, 7.244727626597022e-3, -9.228055941124598e-2,
        5.235987735681432e-1],
    cn=[1.416802502367354e-8, -1.157231412229871e-6, 5.387223446683264e-5,
        -1.604381798862293e-3, 2.818489036795073e-2, -2.467398198317899e-1,
        9.999999760004487e-1],
    fn=[-1.903009855649792e12, 1.355942388050252e11, -4.158143148511033e9,
        7.343848463587323e7, -8.732356681548485e5, 8.560515466275470e3,
        -1.032877601091159e2, 2.999401847870011e0],
    gn=[-1.860843997624650e11, 1.278350673393208e10, -3.779387713202229e8,
        6.492611570598858e6, -7.787789623358162e4, 8.602931494734327e2,
        -1.493439396592284e1, 9.999841934744914e-1])


def _sincospi_sq_half(x):
  """(sin(π x²/2), cos(π x²/2)) with the argument reduced mod 2 first."""
  x = torch.abs(x)
  s = torch.fmod(x, 2.0)
  r = torch.fmod(s * (x - s / 2), 2.0)
  sinpi = torch.where(r < 0.5, torch.sin(_PI * r),
                      torch.where(r > 1.5, torch.sin(_PI * (r - 2.0)),
                                  -torch.sin(_PI * (r - 1.0))))
  cospi = torch.where(r == 0.5, 0.0,
                      torch.where(r < 1.0, -torch.sin(_PI * (r - 0.5)),
                                  torch.sin(_PI * (r - 1.5))))
  return sinpi, cospi


def _fresnel(xxa):
  """Fresnel integrals (S, C), Cephes ``fresnl`` (scipy's float64
  coefficients, the single-precision set for float32)."""
  orig = xxa.dtype
  single = orig != torch.float64
  if single:
    xxa = xxa.to(torch.float32)
  k = _FRESNEL32 if single else _FRESNEL64
  x = torch.abs(xxa)
  x2 = x * x
  t = x2 * x2
  if single:
    s_small = x * x2 * _polyval(k["sn"], t)
    c_small = x * _polyval(k["cn"], t)
  else:
    s_small = x * x2 * _polyval(k["sn"], t) / _polyval(k["sd"], t)
    c_small = x * _polyval(k["cn"], t) / _polyval(k["cd"], t)
  sinpi, cospi = _sincospi_sq_half(x)
  xs = torch.where(x > 0, x, 1.0)
  if single:
    c_large = torch.full_like(x, 0.5)
    s_large = torch.full_like(x, 0.5)
  else:
    c_large = 0.5 + 1 / (_PI * xs) * sinpi
    s_large = 0.5 - 1 / (_PI * xs) * cospi
  t = _PI * xs * xs
  u = 1.0 / (t * t)
  t = 1.0 / t
  if single:
    f = 1.0 - u * _polyval(k["fn"], u)
    g = t * _polyval(k["gn"], u)
  else:
    f = 1.0 - u * _polyval(k["fn"], u) / _polyval(k["fd"], u)
    g = t * _polyval(k["gn"], u) / _polyval(k["gd"], u)
  t = _PI * xs
  c_other = 0.5 + (f * sinpi - g * cospi) / t
  s_other = 0.5 - (f * cospi + g * sinpi) / t
  isinf = torch.isinf(xxa)
  small = x2 < 2.5625
  large = x > 36974.0
  s = torch.where(isinf, 0.5, torch.where(small, s_small, torch.where(
      large, s_large, s_other)))
  c = torch.where(isinf, 0.5, torch.where(small, c_small, torch.where(
      large, c_large, c_other)))
  neg = xxa < 0.0
  s = torch.where(neg, -s, s)
  c = torch.where(neg, -c, c)
  return s.to(orig), c.to(orig)


def fresnel(x):
  """Fresnel integrals (S, C): two lazy outputs."""
  X = sp.lazify(x)
  return (sp.map([X], _lifted(lambda xx: _fresnel(_f(xx))[0])),
          sp.map([X], _lifted(lambda xx: _fresnel(_f(xx))[1])))


_SICI = dict(
    sn=[-8.39167827910303881427E-11, 4.62591714427012837309E-8,
        -9.75759303843632795789E-6, 9.76945438170435310816E-4,
        -4.13470316229406538752E-2, 1.00000000000000000302E0],
    sd=[2.03269266195951942049E-12, 1.27997891179943299903E-9,
        4.41827842801218905784E-7, 9.96412122043875552487E-5,
        1.42085239326149893930E-2, 9.99999999999999996984E-1],
    cn=[2.02524002389102268789E-11, -1.35249504915790756375E-8,
        3.59325051419993077021E-6, -4.74007206873407909465E-4,
        2.89159652607555242092E-2, -1.00000000000000000080E0],
    cd=[4.07746040061880559506E-12, 3.06780997581887812692E-9,
        1.23210355685883423679E-6, 3.17442024775032769882E-4,
        5.10028056236446052392E-2, 4.00000000000000000080E0],
    fn4=[4.23612862892216586994E0, 5.45937717161812843388E0,
         1.62083287701538329132E0, 1.67006611831323023771E-1,
         6.81020132472518137426E-3, 1.08936580650328664411E-4,
         5.48900223421373614008E-7],
    fd4=[1, 8.16496634205391016773E0, 7.30828822505564552187E0,
         1.86792257950184183883E0, 1.78792052963149907262E-1,
         7.01710668322789753610E-3, 1.10034357153915731354E-4,
         5.48900252756255700982E-7],
    gn4=[8.71001698973114191777E-2, 6.11379109952219284151E-1,
         3.97180296392337498885E-1, 7.48527737628469092119E-2,
         5.38868681462177273157E-3, 1.61999794598934024525E-4,
         1.97963874140963632189E-6, 7.82579040744090311069E-9],
    gd4=[1, 1.64402202413355338886E0, 6.66296701268987968381E-1,
         9.88771761277688796203E-2, 6.22396345441768420760E-3,
         1.73221081474177119497E-4, 2.02659182086343991969E-6,
         7.82579218933534490868E-9],
    fn8=[4.55880873470465315206E-1, 7.13715274100146711374E-1,
         1.60300158222319456320E-1, 1.16064229408124407915E-2,
         3.49556442447859055605E-4, 4.86215430826454749482E-6,
         3.20092790091004902806E-8, 9.41779576128512936592E-11,
         9.70507110881952024631E-14],
    fd8=[1.0, 9.17463611873684053703E-1, 1.78685545332074536321E-1,
         1.22253594771971293032E-2, 3.58696481881851580297E-4,
         4.92435064317881464393E-6, 3.21956939101046018377E-8,
         9.43720590350276732376E-11, 9.70507110881952025725E-14],
    gn8=[6.97359953443276214934E-1, 3.30410979305632063225E-1,
         3.84878767649974295920E-2, 1.71718239052347903558E-3,
         3.48941165502279436777E-5, 3.47131167084116673800E-7,
         1.70404452782044526189E-9, 3.85945925430276600453E-12,
         3.14040098946363334640E-15],
    gd8=[1.0, 1.68548898811011640017E0, 4.87852258695304967486E-1,
         4.67913194259625806320E-2, 1.90284426674399523638E-3,
         3.68475504442561108162E-5, 3.57043223443740838771E-7,
         1.72693748966316146736E-9, 3.87830166023954706752E-12,
         3.14040098946363335242E-15])


def _sici(x):
  """Sine and cosine integrals (Cephes ``sici``): the rational series to
  |x| = 4, the asymptotic forms to 1e9, the leading terms beyond."""
  k = _SICI
  xa = torch.abs(x)
  xs = torch.where(xa > 0, xa, 1.0)
  t = xs * xs
  si_s = torch.where(xa == 0, 0.0,
                     xs * _polyval(k["sn"], t) / _polyval(k["sd"], t))
  ci_s = torch.where(xa == 0, -math.inf,
                     _EULER + torch.log(xs)
                     + t * _polyval(k["cn"], t) / _polyval(k["cd"], t))
  s, c = torch.sin(xs), torch.cos(xs)
  z = 1.0 / (xs * xs)
  f4 = _polyval(k["fn4"], z) / (xs * _polyval(k["fd4"], z))
  g4 = z * _polyval(k["gn4"], z) / _polyval(k["gd4"], z)
  f8 = _polyval(k["fn8"], z) / (xs * _polyval(k["fd8"], z))
  g8 = z * _polyval(k["gn8"], z) / _polyval(k["gd8"], z)
  f = torch.where(xs < 8.0, f4, f8)
  g = torch.where(xs < 8.0, g4, g8)
  si_a = _PI / 2 - f * c - g * s
  ci_a = f * s - g * c
  pinf = torch.isposinf(xa)
  si_x = torch.where(pinf, _PI / 2, _PI / 2 - c / xs)
  ci_x = torch.where(pinf, 0.0, s / xs)
  c1 = xa <= 4
  c2 = (xa > 4) & (xa <= 1e9)
  si = torch.where(c1, si_s, torch.where(c2, si_a, si_x))
  ci = torch.where(c1, ci_s, torch.where(c2, ci_a, ci_x))
  si = torch.sign(x) * si
  ci = torch.where(torch.isneginf(x), math.nan, ci)
  return si, ci


def sici(x):
  """Sine/cosine integrals (Si, Ci): two lazy outputs."""
  X = sp.lazify(x)
  return (sp.map([X], _lifted(lambda xx: _sici(_f(xx))[0])),
          sp.map([X], _lifted(lambda xx: _sici(_f(xx))[1])))


def _bessel_jn(z, n, n_iter=50):
  """J_n(z) by Miller's backward recurrence from order ``n_iter``,
  normalized by J_0 + 2 Σ J_2k = 1 (jax's ``bessel_jn``)."""
  f0 = torch.zeros_like(z)
  f1 = torch.full_like(z, 1e-16)
  bs = torch.zeros_like(z)
  fn = None
  f = None
  for k in range(n_iter, -1, -1):
    f = 2.0 * (k + 1.0) * f1 / z - f0
    if k % 2 == 0:
      bs = bs + 2.0 * f
    f0, f1 = f1, f
    if k == n:
      fn = f
  return fn / (bs - f)


def jn(n, x):
  """Integer-order Bessel J_n by the backward recurrence; ``n`` is a
  static int."""
  n = int(n)
  return _mapn(lambda xx: _bessel_jn(_f(xx), n), x)


def j0(x):
  """Bessel J_0 (the backward recurrence)."""
  return jn(0, x)


def j1(x):
  """Bessel J_1 (the backward recurrence)."""
  return jn(1, x)


def factorial(n, exact=False):
  """n! — Γ(n+1) on the device for ``exact=False`` (0 for n < 0); exact
  integers go to the host."""
  if exact:
    return _host_call("factorial", n, exact=True)

  def kern(nn):
    nn = _f(nn)
    return torch.where(nn < 0, 0.0, torch.exp(torch.special.gammaln(nn + 1)))
  return _mapn(kern, n)


def _sph_harm_y(n, m, theta, phi):
  """Y_n^m(θ, φ) with the Condon–Shortley phase (scipy's ``sph_harm_y``):
  the normalized associated Legendre recurrence in n at each element's
  |m|, then e^{imφ}; Y_n^{-m} = (-1)^m conj(Y_n^m), and 0 where |m| > n."""
  nf = _f(n)
  mf = _f(m)
  theta, phi = _f(theta), _f(phi)
  dt = torch.promote_types(theta.dtype, phi.dtype)
  nf, mf, theta, phi = torch.broadcast_tensors(
      nf.to(dt), mf.to(dt), theta.to(dt), phi.to(dt))
  ma = torch.abs(mf)
  ct, st = torch.cos(theta), torch.sin(theta)
  # P̄_|m|^|m| by the product over k = 1..|m|
  pmm = torch.full_like(theta, math.sqrt(1.0 / (4.0 * _PI)))
  for k in range(1, _masked_max(ma, None) + 1):
    step = pmm * (-math.sqrt((2.0 * k + 1.0) / (2.0 * k))) * st
    pmm = torch.where(k <= ma, step, pmm)
  # P̄_l^|m| for l = |m|+1 .. n
  p_prev = pmm
  p = torch.sqrt(2.0 * ma + 3.0) * ct * pmm
  out = torch.where(nf == ma, pmm, torch.zeros_like(pmm))
  out = torch.where(nf == ma + 1, p, out)
  for l in range(2, _masked_max(nf, None) + 1):
    ll = ma + l
    on = ll <= nf
    a_l = torch.sqrt((4.0 * ll * ll - 1.0) / (ll * ll - ma * ma))
    a_lm1 = torch.sqrt((4.0 * (ll - 1) ** 2 - 1.0)
                       / ((ll - 1) ** 2 - ma * ma))
    p_new = a_l * (ct * p - p_prev / a_lm1)
    p_prev, p = (torch.where(on, p, p_prev), torch.where(on, p_new, p))
    out = torch.where(nf == ll, p_new, out)
  out = torch.where(ma > nf, 0.0, out)
  y = out * torch.exp(1j * ma * phi)
  sign = torch.where(torch.remainder(ma, 2) == 0, 1.0, -1.0)
  return torch.where(mf < 0, sign * torch.conj(y), y)


def sph_harm_y(n, m, theta, phi, *, diff_n=0):
  """Spherical harmonics (complex, on the device); derivatives
  (``diff_n != 0``) go to the host."""
  if diff_n != 0:
    return _host_call("sph_harm_y", n, m, theta, phi, diff_n=diff_n)
  return _mapn(_sph_harm_y, n, m, theta, phi)


# ---------------------------------------------------------------------
# composition layer (exact identities over the core)
# ---------------------------------------------------------------------

def erfcx(x):
  """Scaled complementary error function exp(x²)·erfc(x): the log_ndtr
  identity below x=12 (no erfc underflow), the divergent asymptotic series
  1/(x√π)·Σ(-1)^k (2k-1)!!/(2x²)^k above it (10 terms saturate float64 for
  x ≥ 12).  torch's CUDA erfcx compiles at its first call."""
  def kern(xx):
    xx = _f(xx)
    core = torch.exp(xx ** 2 + _LN2
                     + torch.special.log_ndtr(-_SQRT2 * xx))
    xs = torch.clamp_min(xx, 12.0)
    inv2x2 = 1.0 / (2.0 * xs * xs)
    s = torch.ones_like(xs)
    term = torch.ones_like(xs)
    for k in range(1, 11):
      term = term * (-(2 * k - 1)) * inv2x2
      s = s + term
    return torch.where(xx >= 12.0, s / (xs * math.sqrt(_PI)), core)
  return _mapn(kern, x)


def erfcinv(y):
  """Inverse of erfc: -ndtri(y/2)/√2 (exact tail identity)."""
  return _mapn(lambda yy: -torch.special.ndtri(_f(yy) / 2) / _SQRT2, y)


def rgamma(x):
  """1/Γ(x) via gammasgn·exp(-gammaln) (finite everywhere)."""
  return _mapn(lambda xx: _gammasgn(_f(xx))
               * torch.exp(-torch.special.gammaln(_f(xx))), x)


def cosm1(x):
  """cos(x) - 1 without cancellation: -2·sin²(x/2)."""
  return _mapn(lambda xx: -2.0 * torch.sin(_f(xx) / 2) ** 2, x)


def powm1(x, y):
  """x**y - 1 without cancellation: expm1(y·log x) on the smooth branch,
  the direct power elsewhere (negative x, exact zeros)."""
  def kern(xx, yy):
    xx, yy = _bcast(xx, yy)
    safe = xx > 0
    smooth = torch.expm1(yy * torch.log(torch.where(safe, xx, 1.0)))
    return torch.where(safe, smooth, xx ** yy - 1.0)
  return _mapn(kern, x, y)


def exprel(x):
  """(exp(x)-1)/x with the x→0 limit handled."""
  def kern(xx):
    xx = _f(xx)
    tiny = torch.abs(xx) < _eps(xx)
    return torch.where(tiny, 1.0 + xx / 2,
                       torch.expm1(xx) / torch.where(tiny, 1.0, xx))
  return _mapn(kern, x)


# the port's builtins (they fuse and plan onto the fused-reduce kernel)
exp2 = sp.exp2
cbrt = sp.cbrt
log1p = sp.log1p
expm1 = sp.expm1


def exp10(x):
  """10**x (lazy)."""
  return _mapn(lambda xx: 10.0 ** _f(xx), x)


def log_expit(x):
  """log(expit(x)) = -softplus(-x) (stable)."""
  return _mapn(lambda xx: -torch.nn.functional.softplus(-_f(xx)), x)


def logaddexp(a, b):
  """Stable log(e^a + e^b) (lazy)."""
  return _mapn(lambda aa, bb: torch.logaddexp(*_bcast(aa, bb)), a, b)


def softplus(x):
  """log(1 + e^x) (lazy, stable: jax's ``logaddexp(x, 0)``)."""
  return _mapn(lambda xx: torch.logaddexp(_f(xx), torch.zeros_like(_f(xx))),
               x)


def huber(delta, r):
  """Huber loss (scipy convention: 0.5r² core, δ(|r|-δ/2) tails)."""
  def kern(dd, rr):
    dd, rr = _bcast(dd, rr)
    a = torch.abs(rr)
    out = torch.where(a <= dd, 0.5 * rr * rr, dd * (a - 0.5 * dd))
    return torch.where(dd < 0, math.inf, out)
  return _mapn(kern, delta, r)


def pseudo_huber(delta, r):
  """Smooth Huber: δ²(√(1+(r/δ)²) - 1)."""
  def kern(dd, rr):
    dd, rr = _bcast(dd, rr)
    return dd ** 2 * (torch.sqrt(1.0 + (rr / dd) ** 2) - 1.0)
  return _mapn(kern, delta, r)


def boxcox(x, lmbda):
  """Box-Cox transform (λ→0 limit = log x)."""
  def kern(xx, ll):
    xx, ll = _bcast(xx, ll)
    small = torch.abs(ll) < 1e-30
    return torch.where(small, torch.log(xx),
                       torch.expm1(ll * torch.log(xx))
                       / torch.where(small, 1.0, ll))
  return _mapn(kern, x, lmbda)


def boxcox1p(x, lmbda):
  """Box-Cox of 1+x (log1p-stable)."""
  def kern(xx, ll):
    xx, ll = _bcast(xx, ll)
    small = torch.abs(ll) < 1e-30
    return torch.where(small, torch.log1p(xx),
                       torch.expm1(ll * torch.log1p(xx))
                       / torch.where(small, 1.0, ll))
  return _mapn(kern, x, lmbda)


def inv_boxcox(y, lmbda):
  """Inverse Box-Cox."""
  def kern(yy, ll):
    yy, ll = _bcast(yy, ll)
    small = torch.abs(ll) < 1e-30
    return torch.where(small, torch.exp(yy),
                       torch.exp(torch.log1p(ll * yy)
                                 / torch.where(small, 1.0, ll)))
  return _mapn(kern, y, lmbda)


def inv_boxcox1p(y, lmbda):
  """Inverse Box-Cox of 1+x."""
  def kern(yy, ll):
    yy, ll = _bcast(yy, ll)
    small = torch.abs(ll) < 1e-30
    return torch.where(small, torch.expm1(yy),
                       torch.expm1(torch.log1p(ll * yy)
                                   / torch.where(small, 1.0, ll)))
  return _mapn(kern, y, lmbda)


def sindg(x):
  """sin of degrees."""
  return _mapn(lambda xx: torch.sin(torch.deg2rad(_f(xx))), x)


def cosdg(x):
  """cos of degrees."""
  return _mapn(lambda xx: torch.cos(torch.deg2rad(_f(xx))), x)


def tandg(x):
  """tan of degrees."""
  return _mapn(lambda xx: torch.tan(torch.deg2rad(_f(xx))), x)


def cotdg(x):
  """cot of degrees."""
  return _mapn(lambda xx: 1.0 / torch.tan(torch.deg2rad(_f(xx))), x)


def radian(d, m, s):
  """Radians from (degrees, minutes, seconds)."""
  return _mapn(lambda dd, mm, ss:
               torch.deg2rad(_f(dd) + _f(mm) / 60.0 + _f(ss) / 3600.0),
               d, m, s)


def diric(x, n):
  """Dirichlet (periodic sinc) kernel sin(nx/2)/(n sin(x/2)) with the
  removable singularities at x = 2πk filled by the limit ±1."""
  n = int(n)

  def kern(xx):
    xx = _f(xx)
    half = xx / 2
    s = torch.sin(half)
    near = torch.abs(s) < 1e-9
    lim = torch.sign(torch.cos(half) ** (n + 1))
    val = torch.sin(n * half) / (n * torch.where(near, 1.0, s))
    return torch.where(near, lim, val)
  return _mapn(kern, x)


def agm(a, b):
  """Arithmetic-geometric mean — a fixed 40-turn contraction (quadratic
  convergence: 40 is far past float64's)."""
  def kern(aa, bb):
    x, y = _bcast(aa, bb)
    for _ in range(40):
      x, y = (x + y) / 2, torch.sqrt(x * y)
    return (x + y) / 2
  return _mapn(kern, a, b)


def _agm_scan(m):
  """The AGM of (1, √(1-m)) with Σ 2^{n-1} c_n² (for K and E of
  parameter m)."""
  a = torch.ones_like(m)
  b = torch.sqrt(1.0 - m)
  s = 0.5 * m
  for i in range(1, 42):
    cn = (a - b) / 2
    s = s + (2.0 ** i) * cn ** 2 / 2.0
    a, b = (a + b) / 2, torch.sqrt(a * b)
  return a, s


def ellipk(m):
  """Complete elliptic integral K(m) = π/(2·AGM(1, √(1-m)))."""
  def kern(mm):
    mm = _f(mm)
    a, _ = _agm_scan(mm)
    return torch.where(mm == 1.0, math.inf, _PI / (2 * a))
  return _mapn(kern, m)


def ellipkm1(p):
  """K(1-p), accurate near m=1: the AGM on b=√p directly."""
  def kern(pp):
    pp = _f(pp)
    x, y = torch.ones_like(pp), torch.sqrt(pp)
    for _ in range(42):
      x, y = (x + y) / 2, torch.sqrt(x * y)
    return torch.where(pp == 0.0, math.inf, _PI / (x + y))
  return _mapn(kern, p)


def ellipe(m):
  """Complete elliptic integral E(m) via the AGM c_n sum:
  E = K·(1 - Σ 2^{n-1} c_n²)."""
  def kern(mm):
    mm = _f(mm)
    a, s = _agm_scan(mm)
    out = (_PI / (2 * a)) * (1.0 - s)
    return torch.where(mm == 1.0, torch.ones_like(out), out)
  return _mapn(kern, m)


# ---------------------------------------------------------------------
# device inverses (fixed-count bisection)
# ---------------------------------------------------------------------

def _bisect(f, y, lo, hi, iters=80):
  """Solve f(x) = y for f increasing in x on [lo, hi] — a fixed count of
  halvings (independent of the data: no host read)."""
  lo = torch.broadcast_to(lo, y.shape).to(y.dtype)
  hi = torch.broadcast_to(hi, y.shape).to(y.dtype)
  for _ in range(iters):
    mid = (lo + hi) / 2
    gt = f(mid) >= y
    lo, hi = torch.where(gt, lo, mid), torch.where(gt, mid, hi)
  return (lo + hi) / 2


def _gammainc_solve(a, y, qside):
  # Bisect in u = log x: 90 halvings of the ~715-wide log domain give
  # machine-exact relative precision down to x ~ 3e-308.  ``qside`` solves
  # the decreasing complement Q(a, x) = y (the upper tail, where P
  # saturates at 1 - eps).
  hi = torch.log(a + 60.0 * torch.sqrt(a) + 745.0)
  lo = torch.full_like(a, -708.0)
  if qside:
    u = _bisect(lambda uu: -torch.special.gammaincc(a, torch.exp(uu)), -y,
                lo, hi, iters=90)
  else:
    u = _bisect(lambda uu: torch.special.gammainc(a, torch.exp(uu)), y,
                lo, hi, iters=90)
  return torch.exp(u)


def _gammaincinv_kern(a, y):
  a, y = _bcast(a, y)
  xp = _gammainc_solve(a, y, False)
  xq = _gammainc_solve(a, 1.0 - y, True)
  x = torch.where(y <= 0.5, xp, xq)
  return torch.where(y <= 0, 0.0, torch.where(y >= 1, math.inf, x))


def _gammainccinv_kern(a, q):
  a, q = _bcast(a, q)
  xq = _gammainc_solve(a, q, True)
  xp = _gammainc_solve(a, 1.0 - q, False)
  x = torch.where(q <= 0.5, xq, xp)
  return torch.where(q >= 1, 0.0, torch.where(q <= 0, math.inf, x))


def gammaincinv(a, y):
  """Inverse of the regularized lower incomplete gamma P(a, ·) — 90
  halvings a side in log x."""
  return _mapn(lambda aa, yy: _gammaincinv_kern(aa, yy), a, y)


def gammainccinv(a, y):
  """Inverse of Q(a, ·) — solved on the complement side (tail-exact for
  tiny y, where 1-y would saturate)."""
  return _mapn(lambda aa, yy: _gammainccinv_kern(aa, yy), a, y)


def _betaincinv_left(a, b, y):
  u = _bisect(lambda uu: _betainc(a, b, torch.exp(uu)), y,
              torch.full_like(y, -708.0), torch.zeros_like(y), iters=90)
  return torch.exp(u)


def _betaincinv_kern(a, b, y):
  # Two mirrored log-space bisections (I_x(a,b) = 1 - I_{1-x}(b,a)): the
  # left solve is machine-exact for x→0, the mirror for x→1.  Each element
  # solves the side its y lives in, all of them in one bisection over the
  # swapped (a, b, 1 - y) where y > 1/2: each element's halvings are its
  # side's, at half the continued fractions of solving both sides.
  a, b, y = _bcast(a, b, y)
  left = y <= 0.5
  u = _betaincinv_left(torch.where(left, a, b), torch.where(left, b, a),
                       torch.where(left, y, 1.0 - y))
  x = torch.where(left, u, 1.0 - u)
  return torch.where(y <= 0, 0.0, torch.where(y >= 1, 1.0, x))


def betaincinv(a, b, y):
  """Inverse regularized incomplete beta — mirrored log-space bisection."""
  return _mapn(lambda aa, bb, yy: _betaincinv_kern(aa, bb, yy), a, b, y)


def betainccinv(a, b, y):
  """Inverse of the complemented incomplete beta."""
  return _mapn(lambda aa, bb, yy:
               _betaincinv_kern(aa, bb, 1.0 - _f(yy)), a, b, y)


def _kolmogorov_kern(x):
  out = torch.zeros_like(x)
  x2 = x * x
  for k in range(1, 101):
    term = torch.exp(-2.0 * (k * k) * x2)
    out = out + term if k % 2 == 1 else out - term
  out = 2.0 * out
  return torch.clamp(torch.where(x <= 0, 1.0, out), 0.0, 1.0)


def kolmogorov(x):
  """Kolmogorov distribution survival function (the 100-term alternating
  series: float64 saturates for x ≳ 0.04; below that the value is 1)."""
  return _mapn(lambda xx: _kolmogorov_kern(_f(xx)), x)


def kolmogi(p):
  """Inverse of ``kolmogorov`` (decreasing) — bisection on [0, 20]."""
  def kern(pp):
    pp = _f(pp)
    return _bisect(lambda xx: -_kolmogorov_kern(xx), -pp,
                   torch.zeros_like(pp), torch.full_like(pp, 20.0))
  return _mapn(kern, p)


# ---------------------------------------------------------------------
# distribution-CDF family (betainc/gammainc identities)
# ---------------------------------------------------------------------

def _stdtr_kern(df, t):
  df, t = _bcast(df, t)
  ib = _betainc(df / 2, torch.full_like(df, 0.5), df / (df + t ** 2))
  return torch.where(t >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def stdtr(df, t):
  """Student t CDF via the incomplete beta identity."""
  return _mapn(_stdtr_kern, df, t)


def stdtrit(df, p):
  """Student t PPF (inverse of ``stdtr``)."""
  def kern(dd, pp):
    dd, pp = _bcast(dd, pp)
    q = 2.0 * torch.minimum(pp, 1.0 - pp)
    xb = _betaincinv_kern(dd / 2, torch.full_like(dd, 0.5), q)
    t = torch.sqrt(dd * (1.0 - xb) / torch.clamp_min(xb, 1e-300))
    return torch.where(pp >= 0.5, t, -t)
  return _mapn(kern, df, p)


def chdtr(v, x):
  """χ² CDF = P(v/2, x/2)."""
  return _mapn(lambda vv, xx: _gammainc(_f(vv) / 2, _f(xx) / 2), v, x)


def chdtrc(v, x):
  """χ² survival = Q(v/2, x/2)."""
  return _mapn(lambda vv, xx: _gammaincc(_f(vv) / 2, _f(xx) / 2), v, x)


def chdtri(v, p):
  """Inverse χ² survival: x with chdtrc(v, x) = p."""
  return _mapn(lambda vv, pp: 2.0 * _gammainccinv_kern(_f(vv) / 2, pp),
               v, p)


def fdtr(dfn, dfd, x):
  """F CDF via the incomplete beta identity."""
  def kern(a, b, xx):
    a, b, xx = _bcast(a, b, xx)
    return _betainc(a / 2, b / 2, a * xx / (a * xx + b))
  return _mapn(kern, dfn, dfd, x)


def fdtrc(dfn, dfd, x):
  """F survival (complement form, no cancellation)."""
  def kern(a, b, xx):
    a, b, xx = _bcast(a, b, xx)
    return _betainc(b / 2, a / 2, b / (b + a * xx))
  return _mapn(kern, dfn, dfd, x)


def fdtri(dfn, dfd, p):
  """F PPF (inverse of ``fdtr``)."""
  def kern(a, b, pp):
    a, b, pp = _bcast(a, b, pp)
    w = _betaincinv_kern(a / 2, b / 2, pp)
    return b * w / (a * torch.clamp_min(1.0 - w, 1e-300))
  return _mapn(kern, dfn, dfd, p)


def pdtr(k, m):
  """Poisson CDF = Q(⌊k⌋+1, m)."""
  return _mapn(lambda kk, mm: _gammaincc(torch.floor(_f(kk)) + 1, _f(mm)),
               k, m)


def pdtrc(k, m):
  """Poisson survival = P(⌊k⌋+1, m)."""
  return _mapn(lambda kk, mm: _gammainc(torch.floor(_f(kk)) + 1, _f(mm)),
               k, m)


def pdtri(k, p):
  """Poisson PPF in m: m with pdtr(k, m) = p."""
  return _mapn(lambda kk, pp:
               _gammainccinv_kern(torch.floor(_f(kk)) + 1, pp), k, p)


def bdtr(k, n, p):
  """Binomial CDF via betainc(n-k, k+1, 1-p)."""
  def kern(kk, nn, pp):
    kk, nn, pp = _bcast(kk, nn, pp)
    kk = torch.floor(kk)
    out = _betainc(torch.clamp_min(nn - kk, 1e-30), kk + 1, 1.0 - pp)
    return torch.where(kk >= nn, 1.0, torch.where(kk < 0, 0.0, out))
  return _mapn(kern, k, n, p)


def bdtrc(k, n, p):
  """Binomial survival via betainc(k+1, n-k, p)."""
  def kern(kk, nn, pp):
    kk, nn, pp = _bcast(kk, nn, pp)
    kk = torch.floor(kk)
    out = _betainc(kk + 1, torch.clamp_min(nn - kk, 1e-30), pp)
    return torch.where(kk >= nn, 0.0, torch.where(kk < 0, 1.0, out))
  return _mapn(kern, k, n, p)


def bdtri(k, n, y):
  """Binomial inverse in p: p with bdtr(k, n, p) = y."""
  def kern(kk, nn, yy):
    kk, nn, yy = _bcast(kk, nn, yy)
    kk = torch.floor(kk)
    return 1.0 - _betaincinv_kern(torch.clamp_min(nn - kk, 1e-30),
                                  kk + 1, yy)
  return _mapn(kern, k, n, y)


def nbdtr(k, n, p):
  """Negative-binomial CDF = betainc(n, k+1, p)."""
  return _mapn(lambda kk, nn, pp:
               _betainc(_f(nn), torch.floor(_f(kk)) + 1, _f(pp)), k, n, p)


def nbdtrc(k, n, p):
  """Negative-binomial survival = betainc(k+1, n, 1-p)."""
  return _mapn(lambda kk, nn, pp:
               _betainc(torch.floor(_f(kk)) + 1, _f(nn), 1.0 - _f(pp)),
               k, n, p)


def nbdtri(k, n, y):
  """Negative-binomial inverse in p."""
  return _mapn(lambda kk, nn, yy:
               _betaincinv_kern(_f(nn), torch.floor(_f(kk)) + 1, yy),
               k, n, y)


def gdtr(a, b, x):
  """Gamma CDF P(b, a·x)."""
  return _mapn(lambda aa, bb, xx: _gammainc(_f(bb), _f(aa) * _f(xx)),
               a, b, x)


def gdtrc(a, b, x):
  """Gamma survival Q(b, a·x)."""
  return _mapn(lambda aa, bb, xx: _gammaincc(_f(bb), _f(aa) * _f(xx)),
               a, b, x)


def gdtrix(a, b, p):
  """Gamma PPF in x: x with gdtr(a, b, x) = p."""
  return _mapn(lambda aa, bb, pp: _gammaincinv_kern(bb, pp) / _f(aa),
               a, b, p)


# ---------------------------------------------------------------------
# combinatorics (Γ-based device forms; exact ints go to the host)
# ---------------------------------------------------------------------

def binom(x, y):
  """Generalized binomial coefficient by the Γ identity (sign-correct via
  gammasgn products)."""
  def kern(xx, yy):
    xx, yy = _bcast(xx, yy)
    lg = torch.special.gammaln
    lgv = lg(xx + 1) - lg(yy + 1) - lg(xx - yy + 1)
    sg = (_gammasgn(xx + 1) * _gammasgn(yy + 1) * _gammasgn(xx - yy + 1))
    return sg * torch.exp(lgv)
  return _mapn(kern, x, y)


def comb(N, k, *, exact=False, repetition=False):
  """Combinations C(N, k); ``exact=True`` goes to the host (big ints)."""
  if exact:
    return _host_call("comb", N, k, exact=True, repetition=repetition)

  def kern(nn, kk):
    nn, kk = _bcast(nn, kk)
    if repetition:
      nn, kk = nn + kk - 1, kk
    ok = (kk >= 0) & (kk <= nn)
    lg = torch.special.gammaln
    out = torch.exp(lg(nn + 1) - lg(kk + 1) - lg(nn - kk + 1))
    return torch.where(ok, out, 0.0)
  return _mapn(kern, N, k)


def perm(N, k, exact=False):
  """Permutations P(N, k); ``exact=True`` goes to the host."""
  if exact:
    return _host_call("perm", N, k, exact=True)

  def kern(nn, kk):
    nn, kk = _bcast(nn, kk)
    ok = (kk >= 0) & (kk <= nn)
    lg = torch.special.gammaln
    out = torch.exp(lg(nn + 1) - lg(nn - kk + 1))
    return torch.where(ok, out, 0.0)
  return _mapn(kern, N, k)


def factorial2(n, exact=False):
  """Double factorial n!! (Γ identity; exact ints go to the host)."""
  if exact:
    return _host_call("factorial2", n, exact=True)

  def kern(nn):
    nn = _f(nn)
    lg = torch.special.gammaln
    half = nn / 2
    even = torch.exp(half * _LN2 + lg(half + 1))
    odd = torch.exp(lg(nn + 2) - lg(nn / 2 + 1.5) - ((nn + 1) / 2) * _LN2)
    out = torch.where(torch.remainder(torch.floor(nn), 2) == 0, even, odd)
    return torch.where(nn < 0, torch.where(nn == -1, 1.0, 0.0), out)
  return _mapn(kern, n)


def zetac(x):
  """ζ(x) - 1 (underflows to 0 past x ≈ 53, where scipy keeps denormal
  precision)."""
  return _mapn(lambda xx: _zeta(xx, torch.ones_like(_f(xx))) - 1.0, x)


# ---------------------------------------------------------------------
# orthogonal polynomial evaluation (three-term recurrences over the
# static integer degree, unrolled)
# ---------------------------------------------------------------------

def _recurrence(n, x0, x1_fn, step, x):
  """p_n(x) by a three-term recurrence with static n."""
  n = int(n)
  if n < 0:
    raise ValueError("polynomial degree must be >= 0")
  p_prev = torch.full_like(x, x0)
  if n == 0:
    return p_prev
  p = x1_fn(x)
  for k in range(1, n):
    p_prev, p = p, step(k, x, p, p_prev)
  return p


def _poly_op(name, x0, x1_fn, step, doc):
  def op(n, x):
    n = int(n)
    return _mapn(lambda xx: _recurrence(n, x0, x1_fn, step, _f(xx)), x)
  op.__name__ = name
  op.__doc__ = doc
  return op


eval_legendre = _poly_op(
    "eval_legendre", 1.0, lambda x: x,
    lambda k, x, p, pm: ((2 * k + 1) * x * p - k * pm) / (k + 1),
    "Legendre P_n(x) by the three-term recurrence (device).")

eval_chebyt = _poly_op(
    "eval_chebyt", 1.0, lambda x: x,
    lambda k, x, p, pm: 2 * x * p - pm,
    "Chebyshev T_n(x) by recurrence (device).")

eval_chebyu = _poly_op(
    "eval_chebyu", 1.0, lambda x: 2 * x,
    lambda k, x, p, pm: 2 * x * p - pm,
    "Chebyshev U_n(x) by recurrence (device).")

eval_hermite = _poly_op(
    "eval_hermite", 1.0, lambda x: 2 * x,
    lambda k, x, p, pm: 2 * x * p - 2 * k * pm,
    "Physicists' Hermite H_n(x) by recurrence (device).")

eval_hermitenorm = _poly_op(
    "eval_hermitenorm", 1.0, lambda x: x,
    lambda k, x, p, pm: x * p - k * pm,
    "Probabilists' Hermite He_n(x) by recurrence (device).")

eval_laguerre = _poly_op(
    "eval_laguerre", 1.0, lambda x: 1 - x,
    lambda k, x, p, pm: ((2 * k + 1 - x) * p - k * pm) / (k + 1),
    "Laguerre L_n(x) by recurrence (device).")


def eval_genlaguerre(n, alpha, x):
  """Generalized Laguerre L_n^α(x) by recurrence (device)."""
  n = int(n)

  def kern(aa, xx):
    aa, xx = _bcast(aa, xx)
    p_prev = torch.ones_like(xx)
    if n == 0:
      return p_prev
    p = 1 + aa - xx
    for k in range(1, n):
      p_prev, p = p, (((2 * k + 1 + aa - xx) * p
                       - (k + aa) * p_prev) / (k + 1))
    return p
  return _mapn(kern, alpha, x)


def eval_gegenbauer(n, alpha, x):
  """Gegenbauer C_n^α(x) by recurrence (device)."""
  n = int(n)

  def kern(aa, xx):
    aa, xx = _bcast(aa, xx)
    p_prev = torch.ones_like(xx)
    if n == 0:
      return p_prev
    p = 2 * aa * xx
    for k in range(1, n):
      p_prev, p = p, ((2 * (k + aa) * xx * p
                       - (k + 2 * aa - 1) * p_prev) / (k + 1))
    return p
  return _mapn(kern, alpha, x)


# ---------------------------------------------------------------------
# host boundary: everything else in scipy.special, wrapped with the
# once-per-process notice and counted in ``expr.fio.counts["host_runs"]``.
# _HOST_NAMES lists them.
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info("sp.special.%s: no device form — runs EAGERLY on the host "
           "(scipy.special), the sp.linalg.eig convention.", name)


def _host_value(a):
  """An operand as the host sees it: exprs and arrays evaluated and brought
  back through ``glom``; anything else as it is."""
  if isinstance(a, Expr):
    return np.asarray(a.glom())
  if isinstance(a, sp.SpartanArray):
    return np.asarray(a.glom())
  if isinstance(a, torch.Tensor):
    return a.detach().cpu().numpy()
  return a


def _host_call(name, *args, **kw):
  _host_notice(name)
  fio.counts["host_runs"] += 1
  return getattr(_ss, name)(*[_host_value(a) for a in args], **kw)


def _host_special(name):
  def op(*args, **kw):
    return _host_call(name, *args, **kw)
  op.__name__ = name
  op.__doc__ = (f"scipy.special.{name} — host boundary (an eager scipy "
                "call, counted in expr.fio.counts['host_runs']).")
  return op


_HOST_NAMES = []
for _n in dir(_ss):
  if _n.startswith("_") or _n in globals():
    continue
  _obj = getattr(_ss, _n)
  if _inspect.ismodule(_obj):
    continue
  if _inspect.isclass(_obj):
    globals()[_n] = _obj          # errstate / warning classes
    _HOST_NAMES.append(_n)
  elif _py_callable(_obj):
    globals()[_n] = _host_special(_n)
    _HOST_NAMES.append(_n)
_HOST_NAMES = sorted(_HOST_NAMES)

__all__ = sorted(n for n in dir()
                 if not n.startswith("_") and n not in
                 ("annotations", "counts", "functools", "math", "np", "sp",
                  "structural", "torch", "Expr", "fio", "log_info"))
