"""``sp.stats`` of the port (``spartan_tpu_torch/stats.py``) against
scipy.stats and the reference's (``spartan_tpu/stats.py``) on its 8-device
mesh, on the inputs of the reference's ``tests/test_stats.py``.

Tolerances:
* against scipy, each method at the reference test's own tolerance (its
  ``close()``: rtol 1e-10, atol 1e-12; the ppfs rtol 1e-9, atol 1e-10; the
  KS p-values, asymptotic with Stephens' correction, at 2e-2 absolute);
* against the reference, at twice that: both lie within it of scipy, so
  they lie within twice it of each other.  The reference is called once a
  case, its outputs concatenated into one expression (a call compiles);
* the float32 pass at 2e-4 relative with an absolute floor of 2e-5 of the
  largest value (float32's rounding through a few operations);
* the draws against their own distribution: the KS distance to scipy's
  cdf within sqrt(ln(2/alpha) / 2n) at alpha = 1e-6, a discrete one's
  mean and variance within 6 standard errors (torch cannot draw jax's
  stream, so a draw is held to its distribution, not to the reference's).

Where the reference differs from scipy (``REFERENCE_DEFECTS``), the port
is held to scipy alone.  Then the structural maps on a mesh of four
logical shards, the host boundary's count, and the namespace against the
reference's, computed in this process against the same scipy.  About
50 s serial on one core (most of it the reference's compiles).
"""

import numpy as np
import pytest
import scipy.stats as sst
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import stats as stats_mod
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.map import MapExpr, is_structural

st, rst = sp.stats, ref.stats
rng = np.random.default_rng(55)
X2 = rng.uniform(0.5, 9.0, (40, 6))
V = rng.standard_normal(100)
Q = rng.uniform(0.01, 0.99, 32)

# where the reference differs from scipy, the port follows scipy: with
# axis=None on a 2-D array the reference's describe counts the first axis
# as nobs (40 here, scipy 240), and its skewtest/kurtosistest/normaltest
# take n as the first axis's length in their z transforms
REFERENCE_DEFECTS = {"describe_nobs_axis_none", "skewtest_axis_none",
                     "kurtosistest_axis_none", "normaltest_axis_none"}


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def g(e):
  """A result of either package as float64-or-int NumPy."""
  if isinstance(e, tuple):
    return tuple(g(x) for x in e)
  return np.asarray(e.glom()) if hasattr(e, "glom") else np.asarray(e)


def close(ours, want, rtol=1e-10, atol=1e-12):
  np.testing.assert_allclose(g(ours), want, rtol=rtol, atol=atol)


def ref_all(exprs):
  """The reference's exprs evaluated in one call, split back."""
  flat = [ref.lazify(e).ravel() for e in exprs]
  out = np.asarray(ref.concatenate(flat).glom())
  sizes = np.cumsum([0] + [int(np.prod(ref.lazify(e).shape)) for e in exprs])
  return [out[a:b] for a, b in zip(sizes[:-1], sizes[1:])]


_CONT = [
    ("norm", (), 0.5, 2.0),
    ("t", (5.0,), 0.3, 1.5),
    ("chi2", (4.0,), 0.0, 2.0),
    ("gamma", (2.5,), 0.0, 1.3),
    ("beta", (2.0, 3.0), 0.0, 1.0),
    ("f", (4.0, 9.0), 0.0, 1.0),
    ("expon", (), 0.0, 2.0),
    ("uniform", (), 1.0, 3.0),
    ("laplace", (), 0.2, 1.1),
    ("logistic", (), 0.0, 1.0),
    ("cauchy", (), 0.0, 1.0),
    ("lognorm", (0.8,), 0.0, 1.5),
    ("gumbel_r", (), 0.3, 1.2),
    ("gumbel_l", (), 0.0, 1.0),
    ("pareto", (2.5,), 0.0, 1.0),
    ("weibull_min", (1.7,), 0.0, 1.0),
    ("rayleigh", (), 0.0, 1.0),
    ("halfnorm", (), 0.0, 1.0),
    ("truncnorm", (-1.0, 2.0), 0.0, 1.0),
]
_DISC = [("poisson", (3.5,)), ("binom", (12, 0.3)), ("nbinom", (5, 0.4)),
         ("geom", (0.3,)), ("bernoulli", (0.4,))]
_CONT_TOL = {"pdf": (1e-10, 1e-12), "logpdf": (1e-10, 1e-12),
             "cdf": (1e-10, 1e-12), "sf": (1e-10, 1e-12),
             "ppf": (1e-9, 1e-10), "isf": (1e-9, 1e-10)}


def test_every_device_distribution_has_a_case():
  names = {c[0] for c in _CONT} | {c[0] for c in _DISC}
  assert names == set(stats_mod._DEVICE_DISTS)
  assert len(names) == 24


@pytest.mark.parametrize("name,shp,loc,scale", _CONT,
                         ids=[c[0] for c in _CONT])
def test_continuous_distribution(name, shp, loc, scale):
  ours, theirs, want = getattr(st, name), getattr(rst, name), \
      getattr(sst, name)
  a = (*shp, loc, scale)
  xs = want.rvs(*a, size=32, random_state=np.random.RandomState(7))
  got = {}
  for m, (rtol, atol) in _CONT_TOL.items():
    arg = Q if m in ("ppf", "isf") else xs
    out = getattr(ours, m)(arg, *a)
    assert isinstance(out, Expr), "a device method stays lazy"
    got[m] = g(out)
    np.testing.assert_allclose(got[m], getattr(want, m)(arg, *a), rtol=rtol,
                               atol=atol, err_msg=f"{name}.{m}")
  wm, wv = want.mean(*a), want.var(*a)
  if np.isfinite(wm):
    close(ours.mean(*a), wm)
  if np.isfinite(wv):
    close(ours.var(*a), wv)
  # frozen convention + inverse round trip
  close(ours(*a).cdf(xs), want(*a).cdf(xs))
  close(ours.ppf(ours.cdf(xs, *a), *a), xs, rtol=1e-7, atol=1e-8)
  theirs_out = ref_all([getattr(theirs, m)(Q if m in ("ppf", "isf") else xs,
                                           *a) for m in _CONT_TOL])
  for (m, (rtol, atol)), w in zip(_CONT_TOL.items(), theirs_out):
    np.testing.assert_allclose(got[m], w, rtol=2 * rtol, atol=2 * atol,
                               err_msg=f"{name}.{m} against the reference")


@pytest.mark.parametrize("name,shp", _DISC, ids=[c[0] for c in _DISC])
def test_discrete_distribution(name, shp):
  ours, theirs, want = getattr(st, name), getattr(rst, name), \
      getattr(sst, name)
  ks = want.rvs(*shp, size=32, random_state=np.random.RandomState(3))
  methods = {"pmf": ks, "logpmf": ks, "cdf": ks, "ppf": Q}
  got = {m: g(getattr(ours, m)(arg, *shp)) for m, arg in methods.items()}
  for m, arg in methods.items():
    np.testing.assert_allclose(got[m], getattr(want, m)(arg, *shp),
                               rtol=1e-10, atol=1e-12, err_msg=f"{name}.{m}")
  close(ours.mean(*shp), want.mean(*shp), rtol=1e-12)
  close(ours.var(*shp), want.var(*shp), rtol=1e-12)
  close(ours.sf(ks, *shp), want.sf(ks, *shp))
  theirs_out = ref_all([getattr(theirs, m)(arg, *shp)
                        for m, arg in methods.items()])
  for m, w in zip(methods, theirs_out):
    np.testing.assert_allclose(got[m], w, rtol=2e-10, atol=2e-12,
                               err_msg=f"{name}.{m} against the reference")


def test_derived_methods_and_host_calls():
  """logcdf/logsf/std/median/interval/support/stats/entropy; the host
  closed forms (entropy without a device form, skew/kurtosis, moment,
  fit) counted as host runs."""
  close(st.norm.logcdf(V, 1, 2), sst.norm.logcdf(V, 1, 2))
  close(st.norm.logsf(V, 1, 2), sst.norm.logsf(V, 1, 2))
  close(st.gamma.std(2.5, 0, 2.0), sst.gamma.std(2.5, 0, 2.0))
  close(st.t.median(5.0, 0.3), sst.t.median(5.0, 0.3))
  lo, hi = st.norm.interval(0.95, 1, 2)
  wlo, whi = sst.norm.interval(0.95, 1, 2)
  close(lo, wlo)
  close(hi, whi)
  slo, shi = st.uniform.support(1.0, 3.0)
  assert float(g(slo)) == 1.0 and float(g(shi)) == 4.0
  assert float(g(st.expon.support()[1])) == np.inf
  for name, a in (("gamma", (2.5, 0, 2.0)), ("bernoulli", (0.3,)),
                  ("norm", (1.0, 3.0)), ("logistic", ()), ("laplace", ()),
                  ("gumbel_r", ()), ("cauchy", ()), ("uniform", (1, 2)),
                  ("expon", (0, 2)), ("gumbel_l", ())):
    before = fio.counts["host_runs"]
    close(getattr(st, name).entropy(*a), getattr(sst, name).entropy(*a))
    assert fio.counts["host_runs"] == before, f"{name}.entropy is on device"
  before = fio.counts["host_runs"]
  assert abs(st.t.entropy(5.0) - sst.t.entropy(5.0)) < 1e-14
  m, v, s = st.gamma.stats(2.5, moments="mvs")
  close(m, 2.5)
  close(v, 2.5)
  assert abs(s - sst.gamma.stats(2.5, moments="s")) < 1e-14
  assert abs(st.norm.moment(4, 0, 2) - 48.0) < 1e-12
  fitted = st.norm.fit(sp.from_numpy(V))
  np.testing.assert_allclose(fitted, sst.norm.fit(V), rtol=1e-12)
  assert fio.counts["host_runs"] - before == 4


def test_float32_and_int_operands():
  """float32 stays float32 (within float32's rounding of scipy's float64
  of the same points); int and bool operands become float64."""
  x32 = (rng.uniform(0.05, 0.95, 64)).astype(np.float32)
  for name, a in (("norm", (0.5, 2.0)), ("expon", (0.0, 2.0)),
                  ("gamma", (2.5,)), ("beta", (2.0, 3.0))):
    for m in ("pdf", "cdf", "ppf"):
      got = g(getattr(getattr(st, name), m)(sp.from_numpy(x32), *a))
      assert got.dtype == np.float32, f"{name}.{m}"
      want = getattr(getattr(sst, name), m)(x32.astype(np.float64), *a)
      np.testing.assert_allclose(got, want, rtol=2e-4,
                                 atol=2e-5 * np.abs(want).max(),
                                 err_msg=f"float32 {name}.{m}")
  got = g(st.norm.pdf(np.arange(5)))
  assert got.dtype == np.float64
  np.testing.assert_allclose(got, sst.norm.pdf(np.arange(5.0)), rtol=1e-14)
  assert g(st.skew(np.arange(12).reshape(3, 4))).dtype == np.float64
  close(st.gmean(np.arange(1, 9)), sst.gmean(np.arange(1, 9)))
  assert g(st.zscore(np.array([True, False, True, True]))).dtype == \
      np.float64
  close(st.skew(X2.astype(np.float32)), sst.skew(X2), rtol=2e-4, atol=2e-5)
  assert g(st.skew(X2.astype(np.float32))).dtype == np.float32


@pytest.mark.parametrize("name,shp,loc,scale", _CONT + [
    (n, s, 0.0, None) for n, s in _DISC], ids=[c[0] for c in _CONT + _DISC])
def test_rvs_follow_the_distribution(name, shp, loc, scale):
  a = (*shp, loc) if scale is None else (*shp, loc, scale)
  slow = name in ("t", "f", "beta")  # their ppf bisects through betainc
  n = 1024 if slow else 1 << 15
  draws = g(getattr(st, name).rvs(*a, size=n, random_state=11))
  assert draws.shape == (n,) and np.isfinite(draws).all()
  if scale is None:
    w = getattr(sst, name)
    mu, var = w.mean(*a), w.var(*a)
    kurt = w.stats(*a, moments="k")
    assert abs(draws.mean() - mu) <= 6 * np.sqrt(var / n)
    assert abs(draws.var() - var) <= 6 * var * np.sqrt((kurt + 2) / n)
    assert (draws == np.floor(draws)).all()
    return
  d = sst.kstest(draws, getattr(sst, name).cdf, args=a).statistic
  assert d <= np.sqrt(np.log(2 / 1e-6) / (2 * n)), d
  if not slow:  # one seed draws the same values twice
    again = g(getattr(st, name).rvs(*a, size=n, random_state=11))
    np.testing.assert_array_equal(draws, again)


_DESC = [
    ("moment3", "moment", "M", {"order": 3}),
    ("skew", "skew", "M", {}), ("skew_unbiased", "skew", "M", {"bias": False}),
    ("kurtosis", "kurtosis", "M", {}),
    ("kurtosis_unbiased", "kurtosis", "M", {"bias": False}),
    ("kurtosis_pearson", "kurtosis", "M", {"fisher": False}),
    ("gmean", "gmean", "P", {}), ("hmean", "hmean", "P", {}),
    ("pmean", "pmean", "P", {"p": 2.5}), ("sem", "sem", "M", {}),
    ("zscore", "zscore", "M", {}), ("gzscore", "gzscore", "P", {}),
    ("iqr", "iqr", "M", {}), ("iqr_normal", "iqr", "M", {"scale": "normal"}),
    ("iqr_lower", "iqr", "M", {"interpolation": "lower"}),
    ("iqr_midpoint", "iqr", "M", {"interpolation": "midpoint"}),
    ("mad", "median_abs_deviation", "M", {}),
    ("variation", "variation", "P", {}),
    ("tmean", "tmean", "M", {"limits": (-1.0, 2.0)}),
    ("tvar", "tvar", "M", {"limits": (-1.0, 2.0)}),
    ("tstd", "tstd", "M", {"limits": (-1.0, 2.0)}),
    ("tsem", "tsem", "M", {"limits": (-1.0, 2.0)}),
    ("tmin", "tmin", "M", {"lowerlimit": -1.0}),
    ("tmax", "tmax", "M", {"upperlimit": 2.0}),
    ("trim_mean", "trim_mean", "M", {"proportiontocut": 0.1}),
    ("mode", "mode", "R", {}),
    ("rankdata", "rankdata", "R", {}),
    ("rankdata_min", "rankdata", "R", {"method": "min"}),
    ("rankdata_max", "rankdata", "R", {"method": "max"}),
    ("rankdata_dense", "rankdata", "R", {"method": "dense"}),
    ("rankdata_ordinal", "rankdata", "R", {"method": "ordinal"}),
    ("entropy", "entropy", "E", {}),
    ("entropy_base", "entropy", "E", {"base": 2}),
    ("circmean", "circmean", "M", {}), ("circvar", "circvar", "M", {}),
    ("circstd", "circstd", "M", {}), ("gstd", "gstd", "P", {}),
    ("describe", "describe", "M", {}),
]
_M = rng.standard_normal((40, 6)) * 1.5 + 0.5
_DATA = {"M": _M, "P": np.exp(0.3 * _M), "R": np.round(_M * 2),
         "E": np.abs(_M) + 0.1}


def _fields(fn, res):
  if fn == "describe":
    return [res.nobs, *res.minmax, res.mean, res.variance, res.skewness,
            res.kurtosis]
  return list(res) if isinstance(res, tuple) else [res]


@pytest.mark.parametrize("label,fn,key,kw", _DESC, ids=[c[0] for c in _DESC])
def test_descriptive_along_every_axis(label, fn, key, kw):
  """Along axis 0, 1 and None against scipy at 1e-10, and against the
  reference (one call for the three axes) at 2e-10."""
  x = _DATA[key]
  mine, theirs = [], []
  for ax in (0, 1, None):
    got = [g(v) for v in _fields(fn, getattr(st, fn)(x, axis=ax, **kw))]
    want = _fields(fn, getattr(sst, fn)(x, axis=ax, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
      np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                 err_msg=f"{label} axis={ax}")
    res = _fields(fn, getattr(rst, fn)(x, axis=ax, **kw))
    for i, (a, b) in enumerate(zip(got, res)):
      if fn == "describe" and i == 0:  # nobs, a host count
        if ax is None:  # REFERENCE_DEFECTS: describe_nobs_axis_none
          assert b == x.shape[0] and a == x.size
        else:
          assert a == b
        continue
      mine.append(a)
      theirs.append(b)
  for a, b in zip(mine, ref_all(theirs)):
    np.testing.assert_allclose(np.ravel(a), b, rtol=2e-10, atol=2e-12,
                               err_msg=f"{label} against the reference")


def test_trimmed_circular_entropy_of_the_reference_test():
  close(st.tmean(V, (-1, 1)), sst.tmean(V, (-1, 1)))
  close(st.tsem(V, (-1, 1)), sst.tsem(V, (-1, 1)))
  close(st.tmin(V, -1), sst.tmin(V, -1))
  close(st.tmax(V, 1), sst.tmax(V, 1))
  pk, qk = rng.uniform(0.1, 1, 12), rng.uniform(0.1, 1, 12)
  close(st.entropy(pk, qk, base=2), sst.entropy(pk, qk, base=2))
  w = rng.uniform(1, 2, X2.shape)
  close(st.gmean(X2, weights=w), sst.gmean(X2, weights=w))
  close(st.hmean(X2, weights=w), sst.hmean(X2, weights=w))
  close(st.pmean(X2, 0), sst.gmean(X2))
  close(st.zmap(X2[:3], X2), sst.zmap(X2[:3], X2))
  close(st.median_abs_deviation(V, scale="normal"),
        sst.median_abs_deviation(V, scale="normal"))
  m, c = st.mode(np.round(V * 2), keepdims=True)
  wm = sst.mode(np.round(V * 2), keepdims=True)
  assert g(m).shape == (1,) and g(m)[0] == wm.mode[0] and g(c)[0] == \
      wm.count[0]


def _pair(res, want, tol=1e-10):
  close(res.statistic, want.statistic, rtol=tol)
  close(res.pvalue, want.pvalue, rtol=tol, atol=1e-13)


_x = rng.standard_normal(200)
_y = 0.5 * _x + rng.standard_normal(200)
_z = rng.standard_normal(150) + 0.2
_fo = np.array([16, 18, 16, 14, 12, 12.])
_fe = np.array([16, 16, 16, 16, 16, 8.])
_pv = rng.uniform(0.01, 1, 7)
_b = (_x > 0).astype(float)
_TESTS = [
    ("ttest_1samp", lambda S: S.ttest_1samp(_x, 0.1)),
    ("ttest_1samp_greater",
     lambda S: S.ttest_1samp(_x, 0.1, alternative="greater")),
    ("ttest_1samp_less", lambda S: S.ttest_1samp(_x, 0.1, alternative="less")),
    ("ttest_ind", lambda S: S.ttest_ind(_x, _y)),
    ("ttest_welch", lambda S: S.ttest_ind(_x, _y, equal_var=False)),
    ("ttest_rel", lambda S: S.ttest_rel(_x, _y)),
    ("pearsonr", lambda S: S.pearsonr(_x, _y)),
    ("spearmanr", lambda S: S.spearmanr(_x, _y)),
    ("pointbiserialr", lambda S: S.pointbiserialr(_b, _y)),
    ("f_oneway", lambda S: S.f_oneway(_x, _y, _z)),
    ("bartlett", lambda S: S.bartlett(_x, _y, _z)),
    ("levene", lambda S: S.levene(_x, _y, _z)),
    ("levene_mean", lambda S: S.levene(_x, _y, _z, center="mean")),
    ("chisquare", lambda S: S.chisquare(_fo, _fe)),
    ("power_divergence_ll",
     lambda S: S.power_divergence(_fo, _fe, lambda_="log-likelihood")),
    ("power_divergence_cr",
     lambda S: S.power_divergence(_fo, _fe, lambda_="cressie-read")),
    ("combine_fisher", lambda S: S.combine_pvalues(_pv)),
    ("combine_stouffer", lambda S: S.combine_pvalues(_pv, method="stouffer")),
    ("skewtest", lambda S: S.skewtest(_x)),
    ("kurtosistest", lambda S: S.kurtosistest(_x)),
    ("normaltest", lambda S: S.normaltest(_x)),
    ("jarque_bera", lambda S: S.jarque_bera(_x)),
    ("mannwhitneyu", lambda S: S.mannwhitneyu(np.round(_x * 4),
                                              np.round(_y * 4))),
    ("ranksums", lambda S: S.ranksums(_x, _y)),
    ("kruskal", lambda S: S.kruskal(np.round(_x * 4), np.round(_y * 4),
                                    np.round(_z * 4))),
]


@pytest.mark.parametrize("label,call", _TESTS, ids=[c[0] for c in _TESTS])
def test_hypothesis_test(label, call):
  """Statistic and p-value against scipy at 1e-10 (mannwhitneyu against
  its asymptotic method, with ties) and the reference at 2e-10."""
  res = call(st)
  if label == "mannwhitneyu":
    want = sst.mannwhitneyu(np.round(_x * 4), np.round(_y * 4),
                            method="asymptotic")
  else:
    want = call(sst)
  _pair(res, want)
  theirs = call(rst)
  s, p = ref_all([theirs.statistic, theirs.pvalue])
  close(res.statistic, s[0], rtol=2e-10, atol=2e-12)
  close(res.pvalue, p[0], rtol=2e-10, atol=2e-12)


@pytest.mark.parametrize("name", ["skewtest", "kurtosistest",
                                  "normaltest"])
def test_normality_tests_of_a_flattened_array_follow_scipy(name):
  """REFERENCE_DEFECTS: along axis=None the sample size is every element
  (scipy's); the reference's z transforms take the first axis's length,
  so its statistic differs (skewtest -0.126 against scipy's -0.280)."""
  res, want = getattr(st, name)(X2, axis=None), getattr(sst, name)(
      X2, axis=None)
  _pair(res, want)
  theirs, = ref_all([getattr(rst, name)(X2, axis=None).statistic])
  assert not np.allclose(theirs[0], want.statistic, rtol=1e-3)


def test_linregress_and_ks():
  res, want = st.linregress(_x, _y), sst.linregress(_x, _y)
  for f in ("slope", "intercept", "rvalue", "stderr", "intercept_stderr"):
    close(getattr(res, f), getattr(want, f))
  close(res.pvalue, want.pvalue, atol=1e-13)
  theirs = rst.linregress(_x, _y)
  for f, w in zip(("slope", "intercept", "rvalue", "pvalue", "stderr",
                   "intercept_stderr"), ref_all(list(theirs))):
    close(getattr(res, f), w[0], rtol=2e-10, atol=2e-12)
  both = st.linregress(np.stack([_x, _y]))
  close(both.slope, want.slope)
  # device statistic exact; p the Stephens-corrected asymptotic
  x, y = rng.standard_normal(150), rng.standard_normal(120) + 0.3
  res, want = st.kstest(x, "norm"), sst.kstest(x, "norm")
  close(res.statistic, want.statistic)
  np.testing.assert_allclose(g(res.pvalue), want.pvalue, atol=2e-2)
  res2, want2 = st.ks_2samp(x, y), sst.ks_2samp(x, y)
  close(res2.statistic, want2.statistic)
  np.testing.assert_allclose(g(res2.pvalue), want2.pvalue, atol=2e-2)
  theirs = rst.ks_2samp(x, y)
  s, p = ref_all([theirs.statistic, theirs.pvalue])
  close(res2.statistic, s[0], rtol=2e-10)
  close(res2.pvalue, p[0], rtol=2e-10, atol=2e-12)
  close(st.kstest(x, "gamma", args=(2.0,)).statistic,
        sst.kstest(x, "gamma", args=(2.0,)).statistic, rtol=1e-9)
  close(st.ks_1samp(x, "norm").statistic, want.statistic)
  before = fio.counts["host_runs"]
  res3 = st.kstest(x, "alpha", args=(2.0,))  # no device distribution
  assert fio.counts["host_runs"] == before + 1
  assert abs(res3.statistic - sst.kstest(x, "alpha", args=(2.0,))
             .statistic) < 1e-14
  with pytest.raises(NotImplementedError):
    st.spearmanr(X2)
  with pytest.raises(ValueError):
    st.combine_pvalues(_pv, method="pearson")


def test_gaussian_kde_against_scipy_and_the_reference():
  kde, wkde, rkde = st.gaussian_kde(V), sst.gaussian_kde(V), \
      rst.gaussian_kde(V)
  pts = np.linspace(-2, 2, 9)
  np.testing.assert_allclose(np.asarray(kde(pts)), wkde(pts), rtol=1e-9)
  np.testing.assert_allclose(np.asarray(kde.evaluate(pts)),
                             np.asarray(rkde.evaluate(pts)), rtol=2e-9)
  np.testing.assert_allclose(g(kde.logpdf(pts)), wkde.logpdf(pts),
                             rtol=1e-9)
  assert kde.d == 1 and kde.n == 100
  close(kde.neff, wkde.neff)
  close(kde.covariance, wkde.covariance)
  close(kde.inv_cov, wkde.inv_cov)
  close(kde.integrate_box_1d(-1.0, 0.5), wkde.integrate_box_1d(-1.0, 0.5))
  close(kde.integrate_gaussian(0.3, 0.5), wkde.integrate_gaussian(0.3, 0.5))
  other = st.gaussian_kde(V[:40] + 0.5)
  close(kde.integrate_kde(other),
        wkde.integrate_kde(sst.gaussian_kde(V[:40] + 0.5)))
  # 3-D, weighted, silverman
  D = rng.standard_normal((3, 80))
  w = rng.uniform(0.5, 1.5, 80)
  P = rng.standard_normal((3, 11))
  k3 = st.gaussian_kde(D, bw_method="silverman", weights=w)
  w3 = sst.gaussian_kde(D, bw_method="silverman", weights=w)
  np.testing.assert_allclose(np.asarray(k3(P)), w3(P), rtol=1e-9)
  np.testing.assert_allclose(np.asarray(k3.pdf(P)),
                             np.asarray(rst.gaussian_kde(
                                 D, bw_method="silverman", weights=w)(P)),
                             rtol=2e-9)
  close(k3.integrate_gaussian(np.zeros(3), np.eye(3)),
        w3.integrate_gaussian(np.zeros(3), np.eye(3)))
  draws = k3.resample(5, (4, 7))
  assert tuple(draws.shape) == (3, 4, 7)
  with pytest.raises(NotImplementedError):
    k3.set_bandwidth("scott")
  with pytest.raises(NotImplementedError):
    k3.integrate_box(np.zeros(3), np.ones(3))
  with pytest.raises(ValueError):
    k3.integrate_box_1d(0.0, 1.0)


_STRUCTURAL = [
    ("moment", lambda A: st.moment(A, 2)), ("skew", lambda A: st.skew(A)),
    ("kurtosis", lambda A: st.kurtosis(A)), ("gmean", lambda A: st.gmean(A)),
    ("sem", lambda A: st.sem(A)), ("zscore", lambda A: st.zscore(A)),
    ("iqr", lambda A: st.iqr(A, axis=0)),
    ("mad", lambda A: st.median_abs_deviation(A)),
    ("tvar", lambda A: st.tvar(A, (1.0, 8.0))),
    ("trim_mean", lambda A: st.trim_mean(A, 0.1)),
    ("rankdata", lambda A: st.rankdata(A, axis=0)),
    ("mode", lambda A: st.mode(A)[0]),
    ("entropy", lambda A: st.entropy(A)),
    ("circmean", lambda A: st.circmean(A, axis=0)),
    ("describe_var", lambda A: st.describe(A).variance),
    ("ttest_1samp", lambda A: st.ttest_1samp(A, 4.0).statistic),
]


@pytest.mark.parametrize("label,fn", _STRUCTURAL,
                         ids=[c[0] for c in _STRUCTURAL])
def test_structural_maps_on_four_shards(label, fn):
  """Each kernel that reduces, sorts or concatenates is a structural map,
  so the elementwise passes keep its inputs whole: on a mesh of four
  logical shards, ``f(A) + ones(f(A)'s broadcast shape)`` equals scipy's
  value + 1 (an elementwise map there would have its ``ones`` operand
  folded to a scalar and come out in the reduced shape)."""
  sp.initialize(["--device=cpu", "--mesh_shape=4"])
  try:
    A = np.round(X2 * 2) / 2
    e = fn(sp.from_numpy(A))
    assert isinstance(e, MapExpr) and is_structural(e.op), label
    want = np.asarray(g(fn(A)))
    shape = A.shape  # the input's: where ``ones`` would fold
    out = g(e + sp.ones(shape))
    assert out.shape == np.broadcast_shapes(shape, want.shape)
    np.testing.assert_allclose(out, want + np.ones(shape), rtol=1e-12)
  finally:
    sp.initialize(["--device=cpu", "--mesh_shape="])


def test_no_device_name_falls_back_to_scipy(monkeypatch):
  """With scipy.stats hidden from the module, the device distributions,
  statistics and tests still compute, and count no host run."""
  class NoScipy:
    def __getattr__(self, name):
      raise AssertionError(f"scipy.stats.{name} was called")
  monkeypatch.setattr(stats_mod, "_sst", NoScipy())
  before = fio.counts["host_runs"]
  for name, shp, loc, scale in _CONT:
    g(getattr(st, name).cdf(V, *shp, loc, scale))
  g(st.poisson.pmf(np.arange(5), 3.5))
  g(st.skew(X2))
  g(st.ttest_ind(_x, _y).pvalue)
  g(st.mannwhitneyu(_x, _y).pvalue)
  g(st.gaussian_kde(V)(V[:5]))
  assert fio.counts["host_runs"] == before


def test_namespace_matches_the_reference():
  """``__all__`` and ``_HOST_NAMES`` equal the reference's (both depend on
  the installed scipy: computed here against the same one); every
  exported name is defined; nothing of scipy.stats is missing."""
  assert st.__all__ == rst.__all__
  assert st._HOST_NAMES == rst._HOST_NAMES
  for name in st.__all__:
    assert hasattr(st, name), name
  missing = [n for n in dir(sst) if not n.startswith("_")
             and not hasattr(st, n)]
  assert missing == []
  import inspect
  device = [n for n in st.__all__ if n not in st._HOST_NAMES
            and not inspect.ismodule(getattr(st, n))]
  assert len(device) == 76


def test_every_host_function_goes_through_the_counted_boundary(
    monkeypatch):
  """Each wrapped host function once: its expr operand evaluated on the
  host, scipy's function of that name called, one host run counted.
  Classes and distribution objects are scipy's own."""
  calls = []

  class Recorder:
    rv_continuous = sst.rv_continuous
    rv_discrete = sst.rv_discrete

    def __getattr__(self, name):
      def fn(*args, **kw):
        calls.append((name, np.asarray(args[0]).tolist()))
        return name
      return fn
  wrapped = [n for n in st._HOST_NAMES
             if getattr(getattr(st, n), "__module__", "") ==
             "spartan_tpu_torch.stats"]
  assert wrapped and len(wrapped) < len(st._HOST_NAMES)
  monkeypatch.setattr(stats_mod, "_sst", Recorder())
  before = fio.counts["host_runs"]
  operand = sp.from_numpy(np.array([0.5, 1.5]))
  for n in wrapped:
    assert getattr(st, n)(operand) == n
  assert fio.counts["host_runs"] - before == len(wrapped) == len(calls)
  assert all(c == [0.5, 1.5] for _, c in calls)
  assert st.alpha is sst.alpha and st.qmc is sst.qmc
  monkeypatch.undo()
  res, want = st.shapiro(sp.from_numpy(V)), sst.shapiro(V)
  assert abs(res.statistic - want.statistic) < 1e-12
