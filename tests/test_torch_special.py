"""``sp.special`` of the port (``spartan_tpu_torch/special.py``) against
scipy.special and the reference's (``spartan_tpu/special.py``) on its
8-device mesh: each of the 116 device names as a case of one parametrised
test, on the domains of the reference's ``tests/test_special.py``.

Tolerances:
* against scipy, each name at the reference test's own tolerance (its
  ``close()``: rtol 1e-12, atol 1e-13 unless that test loosened it);
  ``hyp1f1``/``hyp2f1`` keep its 1e-3 (jax's series carry about 1e-4
  relative noise on parts of the domain, and the port runs the same
  series);
* against the reference, at twice that: both lie within it of scipy, so
  they lie within twice it of each other;
* where the reference is defective (``REFERENCE_DEFECTS``: it raises), the
  port is held to scipy alone;
* the float32 pass holds the direct core to scipy's float64 value of the
  same float32 inputs at 2e-4 relative, with an absolute floor of 2e-5 of
  the case's largest value (float32's rounding through a few operations,
  where a value near a zero has no relative digits left), and to the
  reference's float32 at the same bound.

Then the int and bool promotion, the lazy fusion of ``tests/test_special.py``
(an expr that fuses with the builtins around it), the namespace against the
reference's ``__all__`` and ``_HOST_NAMES`` computed in this process, and
every host name once through the boundary, counted in
``expr.fio.counts["host_runs"]``.  About 75 s serial on one core (most of it
the reference's compiles).
"""

import numpy as np
import pytest
import scipy.special as ss
import torch

import spartan_tpu as ref
from spartan_tpu.expr.base import Expr as RefExpr

import spartan_tpu_torch as sp
from spartan_tpu_torch import special as special_mod
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr

S, RS = sp.special, ref.special
rng = np.random.default_rng(44)
xp = rng.uniform(0.1, 5.0, 64)          # positive domain
xr = rng.uniform(-4.0, 4.0, 64)         # real line
y01 = rng.uniform(0.01, 0.99, 64)       # open unit interval
mm = np.linspace(-1, 1, 41)
A = rng.normal(size=(8, 16))
YY = np.array([1e-290, 1e-150, 1e-12, 1e-8, 0.3, 0.5, 0.7, 1 - 1e-8,
               1 - 1e-12])
QQ = np.array([1e-280, 1e-12, 0.4, 0.9, 1 - 1e-10])
YB = np.array([1e-60, 1e-12, 0.3, 0.5, 0.7, 1 - 1e-8, 1 - 1e-12])
NN = np.array([2, 3, 4, 1, 5, 0, 7])
MM = np.array([1, -2, 0, 1, -5, 0, 3])
TH = np.linspace(0.2, 2.9, 7)
PH = np.linspace(-1, 3, 7)

# the reference raises on these: its ``_f`` casts polygamma's integer n to
# float, which jax's polygamma refuses; jax's sph_harm_y needs a static
# n_max, which a traced map cannot give; a map cannot return logsumexp's
# (value, sign) pair.  Held to scipy alone (ROADMAP "Reference defects").
REFERENCE_DEFECTS = {"polygamma", "sph_harm_y", "logsumexp_sign"}


def _case(name, args, kw=None, rtol=1e-12, atol=1e-13, fn=None, call=None):
  """``name``: the case id; ``fn``: the function's name (default ``name``);
  ``call``: the call (default ``f(*args, **kw)``)."""
  return pytest.param(fn or name, args, kw or {}, rtol, atol, call, id=name)


CASES = [
    _case("gammaln", (xp,)),
    _case("gamma", (xr,), rtol=1e-10),
    _case("gammasgn", (xr,)),
    _case("digamma", (xp,), rtol=1e-11),
    _case("psi", (xp,), rtol=1e-11),
    _case("rgamma", (xr,), rtol=1e-10, atol=1e-12),
    _case("gammainc", (2.5, xp)),
    _case("gammaincc", (2.5, xp)),
    _case("multigammaln", (xp + 3, 3)),
    _case("poch", (xp, 2.5), rtol=1e-11),
    _case("beta", (xp, 2.0), rtol=1e-11),
    _case("betaln", (xp, 2.0), atol=1e-11),
    _case("betainc", (2.0, 3.5, y01)),
    _case("erf", (xr,)),
    _case("erfc", (xr,), rtol=1e-11),
    _case("erfinv", (y01 * 2 - 1,), rtol=1e-11),
    _case("erfcinv", (y01,), rtol=1e-11),
    _case("erfcx", (np.linspace(-5, 25, 61),)),
    _case("ndtr", (xr,)),
    _case("ndtri", (y01,), rtol=1e-11),
    _case("log_ndtr", (xr,)),
    _case("gammaincinv_0.5", (0.5, YY), rtol=1e-11, fn="gammaincinv"),
    _case("gammaincinv_2.5", (2.5, YY), rtol=1e-11, fn="gammaincinv"),
    _case("gammaincinv_8", (8.0, YY), rtol=1e-11, fn="gammaincinv"),
    _case("gammainccinv", (1.5, QQ), rtol=1e-11),
    _case("betaincinv_left", (0.3, 8.0, YB), rtol=1e-11, fn="betaincinv"),
    _case("betaincinv_right", (8.0, 0.3, YB), rtol=1e-11, fn="betaincinv"),
    _case("betainccinv", (2.0, 3.5, y01), rtol=1e-11),
    _case("stdtr", (4.0, np.linspace(-6, 6, 49))),
    _case("stdtrit", (6.0, y01), rtol=1e-11),
    _case("chdtr", (3.0, xp)),
    _case("chdtrc", (3.0, xp)),
    _case("chdtri", (3.0, y01), rtol=1e-11),
    _case("fdtr", (3.0, 7.0, xp)),
    _case("fdtrc", (3.0, 7.0, xp)),
    _case("fdtri", (3.0, 7.0, y01), rtol=1e-11),
    _case("pdtr", (3, xp)),
    _case("pdtrc", (3, xp)),
    _case("pdtri", (3, y01), rtol=1e-11),
    _case("bdtr", (3, 10, y01), rtol=1e-11),
    _case("bdtrc", (3, 10, y01), rtol=1e-11),
    _case("bdtri", (3, 10, y01), rtol=1e-11),
    _case("nbdtr", (3, 5, y01), rtol=1e-11),
    _case("nbdtrc", (3, 5, y01), rtol=1e-11),
    _case("nbdtri", (3, 5, y01), rtol=1e-11),
    _case("gdtr", (2.0, 3.0, xp)),
    _case("gdtrc", (2.0, 3.0, xp)),
    _case("gdtrix", (2.0, 3.0, y01), rtol=1e-11),
    _case("kolmogorov", (np.linspace(0.05, 2.5, 50),), rtol=1e-12,
          atol=1e-14),
    _case("kolmogi", (y01,), rtol=1e-11),
    _case("ellipk", (np.linspace(-1.5, 0.99, 50),)),
    _case("ellipe", (np.linspace(-1.5, 0.99, 50),)),
    _case("ellipkm1", (np.logspace(-15, -0.1, 30),)),
    _case("agm", (xp, xp[::-1])),
    _case("j0", (xp,), rtol=1e-10),
    _case("j1", (xp,), rtol=1e-10),
    _case("jn", (4, xp), rtol=1e-9),
    _case("i0", (xr,), rtol=1e-11),
    _case("i0e", (xr,), rtol=1e-11),
    _case("i1", (xr,), rtol=1e-11),
    _case("i1e", (xr,), rtol=1e-11),
    _case("exp1", (xp,), rtol=1e-11),
    _case("expi", (xp,), rtol=1e-11),
    _case("expi_negative", (-xp,), rtol=1e-11, fn="expi"),
    _case("expn", (2, xp), rtol=1e-11),
    _case("expn_orders", (np.arange(64) % 6, xp * 2), rtol=1e-11,
          fn="expn"),
    # the power series (x <= 1) at orders 2-5: its harmonic sum
    _case("expn_series", (np.arange(64) % 4 + 2, np.linspace(0.1, 1.0, 64)),
          rtol=1e-12, fn="expn"),
    _case("sici", (xp,), rtol=1e-11),
    _case("fresnel", (xr,), rtol=0, atol=1e-12),
    _case("cosm1", (np.linspace(-0.2, 0.2, 41),)),
    _case("powm1", (xp, xr), rtol=1e-11),
    _case("exprel", (np.linspace(-2, 2, 41),)),
    _case("exp2", (xr,)),
    _case("exp10", (xr,)),
    _case("cbrt", (xr,)),
    _case("log1p", (xp,)),
    _case("expm1", (xr,)),
    _case("expit", (xr,)),
    _case("logit", (y01,)),
    _case("log_expit", (xr,)),
    _case("logaddexp", (xr, xp)),
    _case("softplus", (xr,), fn="softplus",
          call=lambda f, x: f(x)),
    _case("xlogy", (xr, xp)),
    _case("xlog1py", (xr, xp)),
    _case("entr", (xp,)),
    _case("rel_entr", (xp, xp[::-1])),
    _case("kl_div", (xp, xp[::-1])),
    _case("huber", (1.2, xr)),
    _case("pseudo_huber", (1.2, xr)),
    _case("boxcox", (xp, 0.37)),
    _case("boxcox_0", (xp, 0.0), fn="boxcox"),
    _case("boxcox1p", (xp, 0.37)),
    _case("inv_boxcox", (xp, 0.37), rtol=1e-11),
    _case("inv_boxcox1p", (xp, 0.37), rtol=1e-11),
    _case("sindg", (xr * 50,), rtol=0, atol=1e-12),
    _case("cosdg", (xr * 50,), rtol=0, atol=1e-12),
    _case("tandg", (xr * 29,), rtol=1e-10),
    _case("cotdg", (xr * 29 + 7,), rtol=1e-10),
    _case("radian", (30, 15, 10)),
    _case("diric", (np.linspace(-7, 7, 101), 6), rtol=0, atol=1e-12),
    _case("zetac", (np.linspace(1.5, 30, 30),), rtol=1e-10),
    _case("zeta", (np.linspace(1.5, 10, 18), 2.0), rtol=1e-11),
    _case("spence", (xp,), rtol=1e-11),
    _case("softmax", (A,), {"axis": 1}),
    _case("log_softmax", (A,), {"axis": 0}),
    _case("logsumexp", (A,), {"axis": 1}),
    _case("logsumexp_all", (A,), fn="logsumexp"),
    _case("logsumexp_b", (A,), {"axis": 0, "b": np.abs(A[0]) + 0.5},
          fn="logsumexp"),
    _case("logsumexp_sign", (A,), {"axis": 1, "b": np.sign(A[0]),
                                   "return_sign": True}, fn="logsumexp"),
    _case("comb", (np.arange(10), 3)),
    _case("comb_scalar", (12, 5), fn="comb"),
    _case("comb_repetition", (7, 3), {"repetition": True}, fn="comb"),
    _case("perm", (12, 5)),
    _case("binom", (xp * 3, xp), rtol=1e-11),
    _case("factorial", (np.arange(12),)),
    _case("factorial2", (np.arange(15),)),
    _case("eval_legendre", (7, mm), rtol=0, atol=1e-13),
    _case("eval_chebyt", (7, mm), rtol=0, atol=1e-12),
    _case("eval_chebyu", (7, mm), rtol=0, atol=1e-12),
    _case("eval_hermite", (7, xr), rtol=1e-11),
    _case("eval_hermitenorm", (7, xr), rtol=1e-11, atol=1e-12),
    _case("eval_laguerre", (7, xp), rtol=1e-11, atol=1e-12),
    _case("eval_legendre_0", (0, mm), fn="eval_legendre"),
    _case("eval_hermite_3", (3, xr), rtol=1e-11, fn="eval_hermite"),
    _case("eval_genlaguerre", (5, 1.3, xp), rtol=1e-10, atol=1e-12),
    _case("eval_gegenbauer", (5, 0.7, mm), rtol=1e-10, atol=1e-12),
    _case("hyp1f1", (1.5, 2.5, xr), rtol=1e-3),
    _case("hyp1f1_far", (1.5, 2.5, np.linspace(101, 200, 16)), rtol=1e-3,
          fn="hyp1f1"),
    _case("hyp2f1", (1.2, 0.7, 2.5, y01), rtol=1e-3),
    _case("hyp2f1_terminal", (-3.0, 0.7, 2.5, y01), rtol=1e-10,
          fn="hyp2f1"),
    _case("hyp2f1_near_one", (1.2, 0.7, 3.9, np.linspace(0.91, 0.99, 9)),
          rtol=1e-3, fn="hyp2f1"),
    _case("polygamma", (np.arange(64) % 4, xp), rtol=1e-11),
    _case("sph_harm_y", (NN, MM, TH, PH)),
]

# inverses checked by the reference test through a round trip
ROUND_TRIPS = {"inv_boxcox": "boxcox", "inv_boxcox1p": "boxcox1p"}


def _port(name, args, kw, call):
  f = getattr(S, name)
  if name in ROUND_TRIPS:
    args = (getattr(S, ROUND_TRIPS[name])(*args), args[1])
  return call(f, *args) if call else f(*args, **kw)


def _ref(name, args, kw, call):
  f = getattr(RS, name)
  if name in ROUND_TRIPS:
    args = (getattr(RS, ROUND_TRIPS[name])(*args), args[1])
  return call(f, *args) if call else f(*args, **kw)


# device names scipy.special lacks, and their NumPy oracle
NUMPY_ORACLES = {"logaddexp": np.logaddexp}


def _scipy(name, args, kw):
  if name in ROUND_TRIPS:
    return args[0]
  return getattr(ss, name, NUMPY_ORACLES.get(name))(*args, **kw)


def _np(e):
  if isinstance(e, tuple):
    return tuple(_np(x) for x in e)
  if isinstance(e, (Expr, RefExpr)):
    return np.asarray(e.glom())
  return np.asarray(e)


def _check(got, want, rtol, atol):
  if isinstance(want, tuple):
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
      _check(g, w, rtol, atol)
    return
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def test_every_device_name_has_a_case():
  names = {p.values[0] for p in CASES}
  device = set(S.__all__) - set(S._HOST_NAMES)
  assert names == device
  assert len(device) == 116


@pytest.mark.parametrize("name,args,kw,rtol,atol,call", CASES)
def test_device_name_against_scipy_and_the_reference(name, args, kw, rtol,
                                                     atol, call):
  out = _port(name, args, kw, call)
  outs = out if isinstance(out, tuple) else (out,)
  assert all(isinstance(o, Expr) for o in outs), "a device name stays lazy"
  got = _np(out)
  _check(got, _scipy(name, args, kw), rtol, atol)
  case_id = next(p.id for p in CASES if p.values[0] == name
                 and p.values[1] is args)
  if case_id in REFERENCE_DEFECTS or name in REFERENCE_DEFECTS:
    with pytest.raises(Exception):
      _np(_ref(name, args, kw, call))
    return
  _check(got, _np(_ref(name, args, kw, call)), 2 * rtol, 2 * atol)


F32_CORE = [
    ("gamma", (xp,)), ("gammaln", (xp,)), ("gammasgn", (xr,)),
    ("digamma", (xp,)), ("gammainc", (xp, xp[::-1])),
    ("gammaincc", (xp, xp[::-1])), ("beta", (xp, xp[::-1])),
    ("betaln", (xp, xp[::-1])), ("betainc", (xp, xp[::-1], y01)),
    ("erf", (xr,)), ("erfc", (xr,)), ("erfinv", (y01 * 2 - 1,)),
    ("ndtr", (xr,)), ("ndtri", (y01,)), ("log_ndtr", (xr,)),
    ("expit", (xr,)), ("logit", (y01,)), ("entr", (xp,)),
    ("rel_entr", (xp, xp[::-1])), ("kl_div", (xp, xp[::-1])),
    ("xlogy", (xr, xp)), ("xlog1py", (xr, xp)), ("exp1", (xp,)),
    ("expi", (xp,)), ("expn", (np.full(64, 2.0), xp)), ("i0", (xr,)),
    ("i0e", (xr,)), ("i1", (xr,)), ("i1e", (xr,)),
    ("zeta", (xp + 1.5, xp)), ("poch", (xp, xp[::-1])),
    ("hyp1f1", (np.full(64, 1.5), np.full(64, 2.5), xr)),
    ("hyp2f1", (np.full(64, 1.2), np.full(64, 0.7), np.full(64, 2.5),
                y01)),
    ("spence", (xp,)),
]


@pytest.mark.parametrize("name,args", F32_CORE, ids=[c[0] for c in F32_CORE])
def test_direct_core_float32(name, args):
  a32 = [np.asarray(a, np.float32) for a in args]
  got = _np(getattr(S, name)(*[sp.from_numpy(a) for a in a32]))
  assert got.dtype == np.float32
  want = getattr(ss, name)(*[a.astype(np.float64) for a in a32])
  atol = 2e-5 * np.abs(want).max()
  np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol)
  theirs = _np(getattr(RS, name)(*[ref.from_numpy(a) for a in a32]))
  np.testing.assert_allclose(got, theirs, rtol=4e-4, atol=2 * atol)


def test_int_and_bool_operands_become_float64():
  for name in ("gammaln", "erf", "exp2", "cbrt", "digamma", "expit"):
    got = _np(getattr(S, name)(np.arange(1, 9)))
    assert got.dtype == np.float64, name
    np.testing.assert_allclose(got, getattr(ss, name)(np.arange(1, 9.0)),
                               rtol=1e-12, err_msg=name)
  got = _np(S.gammaln(np.array([True, False, True])))
  assert got.dtype == np.float64
  np.testing.assert_allclose(got, ss.gammaln([1.0, 0.0, 1.0]))
  # an int32 operand too, and a weak Python scalar against float32
  assert _np(S.ndtr(np.arange(3, dtype=np.int32))).dtype == np.float64
  x32 = sp.from_numpy(xp.astype(np.float32))
  assert _np(S.gammainc(2.5, x32)).dtype == np.float32
  assert _np(S.betainc(2.0, 3.5, sp.from_numpy(
      y01.astype(np.float32)))).dtype == np.float32


def test_lazy_fusion_and_expr_inputs():
  from spartan_tpu_torch.expr.map import MapExpr
  e = S.erf(sp.from_numpy(xr)) * 2.0 + S.gammaln(sp.from_numpy(xp))
  assert isinstance(e, Expr)
  np.testing.assert_allclose(_np(e), ss.erf(xr) * 2 + ss.gammaln(xp),
                             rtol=1e-12)
  # erf and friends are the port's builtins (they plan as the builtins do)
  for name in ("erf", "erfc", "exp2", "cbrt", "log1p", "expm1"):
    assert getattr(S, name) is getattr(sp, name), name
  # a device name inside a reduction, as one expression
  total = sp.sum(S.ndtr(sp.from_numpy(xr)) * S.expit(sp.from_numpy(xr)))
  np.testing.assert_allclose(float(total.glom()),
                             (ss.ndtr(xr) * ss.expit(xr)).sum(), rtol=1e-12)
  assert isinstance(S.gamma(xr), MapExpr)


def test_converging_loops_read_the_host_in_blocks():
  """``betainc``'s continued fraction freezes converged elements and reads
  on the host once every 8 turns."""
  special_mod.counts.update(reads=0, turns=0)
  _np(S.betainc(2.0, 3.5, y01))
  reads, turns = special_mod.counts["reads"], special_mod.counts["turns"]
  assert turns > 0
  assert reads == -(-turns // 8) + 1 or reads == -(-turns // 8)


def test_no_device_name_falls_back_to_scipy(monkeypatch):
  """With scipy.special hidden from the module, every device case still
  computes: nothing of the device path calls scipy."""
  class NoScipy:
    def __getattr__(self, name):
      raise AssertionError(f"scipy.special.{name} was called")
  monkeypatch.setattr(special_mod, "_ss", NoScipy())
  before = fio.counts["host_runs"]
  for p in CASES:
    name, args, kw, _, _, call = p.values
    _np(_port(name, args, kw, call))
  assert fio.counts["host_runs"] == before


def test_namespace_matches_the_reference():
  assert S.__all__ == RS.__all__
  assert S._HOST_NAMES == RS._HOST_NAMES
  missing = [n for n in dir(ss) if not n.startswith("_")
             and not hasattr(S, n) and callable(getattr(ss, n))]
  assert missing == []


def test_every_host_name_goes_through_the_counted_boundary(monkeypatch):
  """Each host name once: the wrapper evaluates an expr operand on the
  host, calls scipy's function of that name and counts a host run."""
  calls = []

  class Recorder:
    def __getattr__(self, name):
      def fn(*args, **kw):
        calls.append((name, args, kw))
        return name
      return fn
  monkeypatch.setattr(special_mod, "_ss", Recorder())
  wrapped = [n for n in S._HOST_NAMES
             if not isinstance(getattr(S, n), type)]
  before = fio.counts["host_runs"]
  operand = sp.from_numpy(np.array([0.5, 1.5]))
  for n in wrapped:
    assert getattr(S, n)(operand, 2.0, flag=True) == n
  assert fio.counts["host_runs"] - before == len(wrapped)
  assert [c[0] for c in calls] == wrapped
  for _, args, kw in calls:
    np.testing.assert_array_equal(args[0], [0.5, 1.5])
    assert args[1] == 2.0 and kw == {"flag": True}
  for n in set(S._HOST_NAMES) - set(wrapped):
    assert getattr(S, n) is getattr(ss, n)


def test_host_boundary_against_scipy():
  before = fio.counts["host_runs"]
  for a, w in zip(S.airy(xr), ss.airy(xr)):
    np.testing.assert_allclose(a, w, rtol=1e-12)
  np.testing.assert_allclose(S.struve(0, xp), ss.struve(0, xp))
  np.testing.assert_allclose(S.yv(0.5, xp), ss.yv(0.5, xp))
  np.testing.assert_allclose(S.kv(1.5, xp), ss.kv(1.5, xp))
  np.testing.assert_allclose(S.ellipkinc(0.7, 0.3), ss.ellipkinc(0.7, 0.3))
  np.testing.assert_allclose(S.yn(1, sp.from_numpy(xp)), ss.yn(1, xp))
  np.testing.assert_allclose(S.smirnov(10, 0.3), ss.smirnov(10, 0.3))
  assert S.comb(12, 5, exact=True) == ss.comb(12, 5, exact=True)
  assert S.factorial(21, exact=True) == ss.factorial(21, exact=True)
  assert S.perm(9, 4, exact=True) == ss.perm(9, 4, exact=True)
  assert S.factorial2(11, exact=True) == ss.factorial2(11, exact=True)
  for a, w in zip(S.sph_harm_y(3, 1, 0.4, 0.2, diff_n=1),
                  ss.sph_harm_y(3, 1, 0.4, 0.2, diff_n=1)):
    np.testing.assert_allclose(a, w, rtol=1e-12)
  assert fio.counts["host_runs"] - before == 12
