"""The port's sorts and searches (``expr/sort_expr.py``'s ``SortExpr``;
``sort``, ``argsort``, ``msort``, ``partition``, ``argpartition``,
``lexsort``, ``sort_complex``, ``searchsorted``, ``digitize``,
``permutation``, ``choice`` and the ``Expr`` methods) against NumPy and
the reference on its 8-device CPU mesh, on seeded inputs carried across
with ``interop.from_reference``.  The reference's ``tests/test_sort.py``
has its counterparts here (its percentile tests among them).

Every ordering and search is held exactly: argsorts to NumPy's stable
argsort, so ties (heavy integer ties, ``-0.0`` beside ``+0.0``, several
NaNs) keep their input order.  ``--sort_sample_threshold`` lowered in the
reference sends it down its sample sort on 8 CPU devices, and the port's
one ``torch.sort`` is held to that exactly too, on ties and NaN (not on
ties of ``-0.0`` with ``+0.0``, which that route breaks).

Pinned (ROADMAP): ``searchsorted`` and ``digitize`` give NumPy's int64
(the reference int32) and NumPy's answer for NaN; ``digitize`` of
decreasing bins is NumPy's ``len(bins) - searchsorted(bins[::-1], x)``
(the reference searches the decreasing bins as they are);
``sort_complex`` of float32 is NumPy's complex128 (the reference
complex64); ``partition``/``argpartition`` are a full sort, as the
reference's; ``permutation``/``choice`` draw from torch's generator, not
``jax.random``; ``--sort_method=sample`` raises ``NotImplementedError`` for every sort.
"""

import contextlib

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.config import FLAGS as REF_FLAGS

import spartan_tpu_torch as sp
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.expr.base import EmitCtx
from spartan_tpu_torch.expr.sort_expr import PercentileExpr, SortExpr


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(17)
F64 = RNG.standard_normal((6, 7))
SPECIAL = F64.copy()
SPECIAL[0, [1, 4, 6]] = np.nan
SPECIAL[1, [0, 2, 3, 5]] = [0.0, -0.0, 0.0, -0.0]
SPECIAL[2, [1, 2]] = [np.inf, -np.inf]
SPECIAL[3] = [-0.0, np.nan, 0.0, -np.nan, -0.0, 0.0, np.nan]
SPECIAL[:, 3] = [0.0, -0.0, np.nan, -0.0, 0.0, np.nan]
DATA = {"float64": F64, "float32": F64.astype(np.float32),
        "int32": RNG.integers(-2, 3, (6, 7)).astype(np.int32),
        "bool": RNG.random((6, 7)) < 0.5,
        "uint8": RNG.integers(0, 4, (6, 7)).astype(np.uint8),
        "ties": RNG.integers(0, 3, (6, 7)).astype(np.float64),
        "special": SPECIAL, "empty": np.zeros((0, 3))}
KINDS = tuple(DATA)


def _glom(x):
  return np.asarray(x.glom())


def _carried(x):
  """``x`` as the reference holds it, and carried across to the port."""
  r = ref.from_numpy(x)
  return r, sp.interop.from_reference(r)


def _same(got, want, dtype=True):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if dtype:
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
  np.testing.assert_array_equal(got, want)
  if got.dtype.kind == "f":  # -0.0 and +0.0 in NumPy's places
    num = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]))


AXES = (-1, 0, None)
# name → (call over a module m, NumPy's call)
CASES = {
    "sort": (lambda m, x, a: m.sort(x, axis=a),
             lambda x, a: np.sort(x, axis=a, kind="stable")),
    "argsort": (lambda m, x, a: m.argsort(x, axis=a),
                lambda x, a: np.argsort(x, axis=a, kind="stable")),
    "partition": (lambda m, x, a: m.partition(x, 0, axis=a),
                  lambda x, a: np.sort(x, axis=a, kind="stable")),
    "argpartition": (lambda m, x, a: m.argpartition(x, 0, axis=a),
                     lambda x, a: np.argsort(x, axis=a, kind="stable")),
}


@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sorts_against_numpy_and_the_reference(name, kind, axis):
  call, np_call = CASES[name]
  x = DATA[kind]
  r, p = _carried(x)
  e = call(sp, p, axis)
  got = _glom(e)
  assert e.shape == got.shape
  _same(got, np_call(x, axis))
  _same(got, _glom(call(ref, r, axis)))


@pytest.mark.parametrize("kind", KINDS)
def test_msort(kind):
  x = DATA[kind]
  r, p = _carried(x)
  got = _glom(sp.msort(p))
  _same(got, np.sort(x, axis=0))
  _same(got, _glom(ref.msort(r)))


def test_partition_puts_kth_in_its_sorted_place():
  x = DATA["float64"]
  for k in (0, 3, 6):
    got = _glom(sp.partition(x, k, axis=1))
    want = np.partition(x, k, axis=1)
    np.testing.assert_array_equal(got[:, k], want[:, k])
    assert (got[:, :k] <= got[:, k:k + 1]).all()
    assert (got[:, k:] >= got[:, k:k + 1]).all()
    idx = _glom(sp.argpartition(x, k, axis=1))
    np.testing.assert_array_equal(np.take_along_axis(x, idx, 1)[:, k],
                                  want[:, k])


@pytest.mark.parametrize("kind", ["float64", "float32", "int32", "uint8"])
def test_argsort_of_ties_keeps_input_order_at_length(kind):
  """Long runs of equal keys (and of ±0.0 and of NaN with and without
  the sign bit in floats): the order of the indices inside each run is
  the input order."""
  rng = np.random.default_rng(5)
  x = rng.integers(0, 4, 4099).astype(kind)
  if kind.startswith("float"):
    x[rng.random(x.size) < 0.2] = np.nan
    x[rng.random(x.size) < 0.05] = -np.nan  # the sign bit set
    zeros = rng.random(x.size) < 0.2
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
  got = _glom(sp.argsort(x))
  _same(got, np.argsort(x, kind="stable"))


def test_sort_method_sample_raises_and_gather_sorts():
  x = sp.from_numpy(DATA["float64"])
  for method in ("auto", "gather"):
    FLAGS.sort_method = method
    try:
      _same(_glom(sp.sort(x, axis=None)), np.sort(DATA["float64"], None))
    finally:
      FLAGS.sort_method = "auto"
  FLAGS.sort_method = "sample"
  try:
    for e in (sp.sort(x), sp.argsort(x, axis=None), sp.median(x),
              sp.percentile(x, [10, 90], axis=0), sp.permutation(8)):
      with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        e.glom()
  finally:
    FLAGS.sort_method = "auto"
  FLAGS.sort_method = "merge"
  try:
    with pytest.raises(ValueError, match="sort_method"):
      sp.sort(x).glom()
  finally:
    FLAGS.sort_method = "auto"


# every sort of the port, each raising under --sort_method=sample
SAMPLE_RAISES = {
    "nanmedian": lambda x: sp.nanmedian(x),
    "nanpercentile": lambda x: sp.nanpercentile(x, [10, 90], axis=1),
    "nanquantile": lambda x: sp.nanquantile(x, 0.3),
    "quantile": lambda x: sp.quantile(x, 0.3, axis=0),
    "lexsort": lambda x: sp.lexsort([x, -x]),
    "sort_complex": lambda x: sp.sort_complex(x),
    "msort": lambda x: sp.msort(x),
    "partition": lambda x: sp.partition(x, 2),
    "unique": lambda x: sp.unique(x),
    "union1d": lambda x: sp.union1d(x, -x),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_RAISES))
def test_sort_method_sample_raises_for_every_sort(name):
  x = sp.from_numpy(DATA["float64"])
  FLAGS.sort_method = "sample"
  try:
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
      _glom(SAMPLE_RAISES[name](x))
  finally:
    FLAGS.sort_method = "auto"
  _glom(SAMPLE_RAISES[name](x))


def test_sample_routable_is_false_on_the_ports_mesh():
  from spartan_tpu_torch.expr.sort_expr import _sample_routable
  with sp.with_mesh(sp.make_mesh("cpu", shape=(8,))):
    for method in ("auto", "gather"):
      FLAGS.sort_method = method
      try:
        assert not _sample_routable()
        got = _glom(sp.argsort(np.arange(64.0)[::-1].copy()))
      finally:
        FLAGS.sort_method = "auto"
      _same(got, np.arange(64)[::-1])


@contextlib.contextmanager
def reference_sample_sort(monkeypatch):
  """The reference's ``auto`` routed to its sample sort on 8 CPU devices
  (threshold lowered, restored after), with its calls of the sample sort
  and of the rank selection counted."""
  import spartan_tpu.parallel.sample_sort as ss
  calls = {"sort": 0, "select": 0}
  sort_traced, rank_values = ss.sample_sort_traced, ss.rank_values

  def counted_sort(*a, **k):
    calls["sort"] += 1
    return sort_traced(*a, **k)

  def counted_select(*a, **k):
    calls["select"] += 1
    return rank_values(*a, **k)

  monkeypatch.setattr(ss, "sample_sort_traced", counted_sort)
  monkeypatch.setattr(ss, "rank_values", counted_select)
  old = REF_FLAGS.sort_sample_threshold
  REF_FLAGS.sort_sample_threshold = 64
  try:
    yield calls
  finally:
    REF_FLAGS.sort_sample_threshold = old


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
def test_gather_route_equals_the_references_sample_sort(monkeypatch, dtype):
  rng = np.random.default_rng(23)
  n = 8 * 1031  # a length of its own, so no cached region of another route
  x = rng.integers(-50, 50, n).astype(dtype)  # ties, +0.0 among them
  if dtype != "int32":
    x[rng.random(n) < 0.05] = np.nan
  r, p = _carried(x)
  with reference_sample_sort(monkeypatch) as calls:
    rs, ra = _glom(ref.sort(r)), _glom(ref.argsort(r))
    rp = _glom(ref.percentile(r, [0, 13, 50, 99.9, 100]))
  assert calls["sort"] >= 2 and calls["select"] >= 1, calls
  _same(_glom(sp.sort(p)), rs)
  _same(_glom(sp.argsort(p)), ra)
  got = _glom(sp.percentile(p, [0, 13, 50, 99.9, 100]))
  assert got.dtype == rp.dtype
  # the same order statistics; the reference's lerp is a + (b - a) * t,
  # NumPy's and the port's b - (b - a) * (1 - t) for t >= 0.5
  np.testing.assert_allclose(got, rp, rtol=1e-12, atol=0)


def test_the_references_sample_sort_breaks_signed_zero_ties(monkeypatch):
  """A reference defect the port does not copy: on alternating -0.0 and
  +0.0, which tie, its sample sort's argsort is not the stable one that
  NumPy, its own gather route and the port give (the identity)."""
  n = 8 * 1033
  x = np.where(np.arange(n) % 2 == 0, 0.0, -0.0)
  r, p = _carried(x)
  with reference_sample_sort(monkeypatch) as calls:
    ra = _glom(ref.argsort(r))
  assert calls["sort"] >= 1
  want = np.argsort(x, kind="stable")
  _same(want, np.arange(n))
  _same(_glom(sp.argsort(p)), want)
  assert not np.array_equal(ra, want)


@pytest.mark.parametrize("keys", ["ints", "mixed", "three"])
def test_lexsort(keys):
  rng = np.random.default_rng(3)
  ks = {"ints": [rng.integers(0, 3, 40), rng.integers(0, 3, 40)],
        "mixed": [rng.standard_normal(40), rng.integers(0, 2, 40) > 0],
        "three": [rng.integers(0, 2, 40), rng.integers(0, 2, 40).astype(
            np.float32), rng.integers(0, 3, 40).astype(np.int32)]}[keys]
  got = _glom(sp.lexsort([sp.from_numpy(k) for k in ks]))
  _same(got, np.lexsort(ks))
  _same(got, _glom(ref.lexsort([ref.from_numpy(k) for k in ks])))
  ks2 = [k.reshape(5, 8) for k in ks]
  for axis in (-1, 0):
    got = _glom(sp.lexsort([sp.from_numpy(k) for k in ks2], axis=axis))
    _same(got, np.lexsort(ks2, axis=axis))
  with pytest.raises(TypeError, match="len > 0"):
    sp.lexsort([])


@pytest.mark.parametrize("kind", ["complex128", "complex64", "float64",
                                  "float32", "int32", "int8", "bool"])
def test_sort_complex(kind):
  rng = np.random.default_rng(4)
  re_, im = rng.integers(-2, 3, (3, 9)), rng.integers(-2, 3, (3, 9))
  x = ((re_ + 1j * im).astype(kind) if kind.startswith("complex")
       else re_.astype(kind) if kind != "bool" else re_ > 0)
  got = _glom(sp.sort_complex(x))
  _same(got, np.sort_complex(x))
  rgot = _glom(ref.sort_complex(ref.from_numpy(x)))
  np.testing.assert_array_equal(got, rgot)


def test_sort_of_complex_is_numpys_order():
  rng = np.random.default_rng(6)
  x = (rng.integers(-2, 3, 30) + 1j * rng.integers(-2, 3, 30))
  _same(_glom(sp.sort(x)), np.sort(x))
  _same(_glom(sp.argsort(x)), np.argsort(x, kind="stable"))


BOUNDS = {"float64": np.array([-1.5, -0.0, 0.0, 0.5, 0.5, 2.0, np.inf]),
          "float32": np.array([-1.5, 0.0, 0.5, 0.5, 2.0], np.float32),
          "int32": np.array([-3, 0, 0, 2, 5], np.int32),
          "nan": np.array([1.0, 2.0, 2.0, np.inf, np.nan, np.nan]),
          "bool": np.array([False, True, True])}
QUERIES = {"float64": np.array([-2.0, -1.5, 0.0, -0.0, 0.25, 0.5, 3.0, np.inf,
                                -np.inf, np.nan]),
           "float32": np.array([-2.0, 0.0, 0.5, 7.0], np.float32),
           "int32": np.array([-4, -3, 0, 1, 2, 5, 6], np.int32),
           "nan": np.array([np.nan, 5.0, 2.0, np.inf, -np.inf, 1.0]),
           "bool": np.array([True, False])}


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", sorted(BOUNDS))
def test_searchsorted(kind, side):
  a, q = BOUNDS[kind], QUERIES[kind]
  ra, pa = _carried(a)
  rq, pq = _carried(q)
  got = _glom(sp.searchsorted(pa, pq, side=side))
  _same(got, np.searchsorted(a, q, side=side))
  _same(_glom(sp.lazify(pa).searchsorted(pq, side=side)), got)
  if kind != "nan":  # the reference: int32, and torch's order of NaN
    np.testing.assert_array_equal(
        got, _glom(ref.searchsorted(ra, rq, side=side)))


def test_searchsorted_of_nan_is_numpys():
  a, q = np.array([1.0, 2.0, np.nan]), np.array([np.nan, 5.0])
  for side, want in (("left", [2, 2]), ("right", [3, 2])):
    got = _glom(sp.searchsorted(a, q, side=side))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.searchsorted(a, q, side=side))
  assert torch.searchsorted(torch.tensor(a), torch.tensor(q)).tolist() == [
      3, 3]


def test_searchsorted_promotes_and_keeps_the_query_shape():
  a = np.array([0, 2, 4, 6], np.int32)
  q = np.array([[1.5, 2.0], [6.5, -1.0]])
  got = _glom(sp.searchsorted(a, q))
  _same(got, np.searchsorted(a, q))
  assert int(sp.searchsorted(a, 3.5).glom()) == np.searchsorted(a, 3.5)
  with pytest.raises(ValueError, match="side"):
    sp.searchsorted(a, q, side="middle")
  with pytest.raises(ValueError, match="1-dimensional"):
    sp.searchsorted(np.zeros((2, 2)), q)


DIGITIZE_X = np.array([-1.0, 0.0, 0.2, 1.0, 1.5, 2.5, 3.0, 4.0, 9.0, np.nan])


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("bins", ["increasing", "decreasing", "one", "ties"])
def test_digitize(bins, right):
  b = {"increasing": np.array([0.0, 1.0, 2.5, 4.0]),
       "decreasing": np.array([4.0, 2.5, 1.0, 0.0]),
       "one": np.array([1.0]),
       "ties": np.array([0.0, 1.0, 1.0, 3.0])}[bins]
  rb, pb = _carried(b)
  rx, px = _carried(DIGITIZE_X)
  got = _glom(sp.digitize(px, pb, right=right))
  _same(got, np.digitize(DIGITIZE_X, b, right=right))
  if bins != "decreasing":
    fin = ~np.isnan(DIGITIZE_X)
    np.testing.assert_array_equal(
        got[fin], _glom(ref.digitize(rx, rb, right=right))[fin])


def test_digitize_of_decreasing_bins_follows_numpy_not_the_reference():
  b, x = np.array([3.0, 2.0, 1.0]), np.array([0.5, 1.5, 2.5, 3.5])
  got = _glom(sp.digitize(x, b))
  np.testing.assert_array_equal(got, np.digitize(x, b))
  np.testing.assert_array_equal(got, [3, 2, 1, 0])
  assert not np.array_equal(_glom(ref.digitize(ref.from_numpy(x),
                                               ref.from_numpy(b))), got)
  with pytest.raises(TypeError, match="complex"):
    sp.digitize(x.astype(complex), b)


def test_permutation_and_choice():
  sp.set_random_seed(3)
  for n in (1, 7, 1000):
    got = _glom(sp.permutation(n))
    _same(np.sort(got), np.arange(n))
  x = np.arange(20.0).reshape(10, 2)
  got = _glom(sp.permutation(x))
  assert got.shape == x.shape
  _same(got[np.argsort(got[:, 0])], x)
  pop = np.arange(100, 130)
  without = _glom(sp.choice(pop, 12, replace=False))
  assert without.shape == (12,) and len(set(without.tolist())) == 12
  assert set(without.tolist()) <= set(pop.tolist())
  with_ = _glom(sp.choice(30, 500))
  assert with_.shape == (500,) and with_.min() >= 0 and with_.max() < 30
  with pytest.raises(ValueError, match="larger sample"):
    sp.choice(5, 6, replace=False)
  with pytest.raises(ValueError, match="1-dimensional"):
    sp.choice(np.zeros((2, 2)), 1)
  with pytest.raises(ValueError, match="larger sample"):
    ref.choice(5, 6, replace=False)


def test_expr_sort_methods():
  x = DATA["special"]
  r, p = _carried(x)
  e, re_ = sp.lazify(p), ref.lazify(r)
  for name, args in (("sort", ()), ("argsort", ()), ("partition", (2,)),
                     ("argpartition", (2,))):
    for axis in (-1, 0):
      got = _glom(getattr(e, name)(*args, axis=axis))
      _same(got, _glom(getattr(re_, name)(*args, axis=axis)))


def test_sort_shapes_come_from_meta_tensors():
  x = sp.from_numpy(DATA["int32"])
  meta = [torch.empty((6, 7), dtype=torch.int32, device="meta")]
  for e, shape, dtype in ((SortExpr(x, None, "sort"), (42,), torch.int32),
                          (SortExpr(x, 0, "argsort"), (6, 7), torch.int64),
                          (PercentileExpr(x, (0.1, 0.9), 1), (2, 6),
                           torch.float64),
                          (PercentileExpr(x, 0.5, 0, ignore_nan=True), (7,),
                           torch.float64)):
    v = e._emit(EmitCtx(abstract=True), meta)
    assert v.device.type == "meta"
    assert tuple(v.shape) == shape == e.shape and v.dtype == dtype == e.dtype


# the reference's tests/test_sort.py, held against NumPy and the reference

def test_sort(rng):
  a = rng.standard_normal((12, 16))
  r, p = _carried(a)
  _same(_glom(sp.sort(p)), np.sort(a))
  _same(_glom(sp.sort(p, axis=0)), np.sort(a, axis=0))
  v = rng.standard_normal(100)
  _same(_glom(sp.sort(sp.from_numpy(v))), np.sort(v))
  _same(_glom(sp.sort(p, axis=None)), np.sort(a, axis=None))
  _same(_glom(sp.sort(p, axis=None)), _glom(ref.sort(r, axis=None)))


def test_argsort(rng):
  a = rng.standard_normal((8, 10))
  r, p = _carried(a)
  _same(_glom(sp.argsort(p)), np.argsort(a))
  _same(_glom(sp.argsort(p, axis=0)), np.argsort(a, axis=0))
  _same(_glom(sp.argsort(p, axis=0)), _glom(ref.argsort(r, axis=0)))


def test_percentile_median(rng):
  a = rng.standard_normal(500)
  r, p = _carried(a)
  for q in (50, 90):
    got = float(sp.percentile(p, q).glom())
    np.testing.assert_allclose(got, np.percentile(a, q), rtol=1e-12)
    np.testing.assert_allclose(got, float(ref.percentile(r, q).glom()),
                               rtol=1e-12)
  np.testing.assert_allclose(float(sp.median(p).glom()), np.median(a),
                             rtol=1e-12)
  b = rng.standard_normal((20, 30))
  np.testing.assert_allclose(_glom(sp.percentile(sp.from_numpy(b), 25,
                                                 axis=0)),
                             np.percentile(b, 25, axis=0), rtol=1e-12)


def test_sort_feeds_lazy_chain(rng):
  a = rng.standard_normal(64)
  got = sp.sum(sp.sort(sp.from_numpy(a))[:10])
  want = np.sort(a)[:10].sum()
  np.testing.assert_allclose(float(got.glom()), want, rtol=1e-12)


def test_int_sort(rng):
  x = rng.integers(0, 1000, (50,))
  r, p = _carried(x)
  _same(_glom(sp.sort(p)), np.sort(x))
  _same(_glom(sp.sort(p)), _glom(ref.sort(r)))


def test_quantile_matches_numpy(rng):
  a = rng.standard_normal((32,))
  r, p = _carried(a)
  for q in (0.0, 0.25, 0.5, 0.9, 1.0):
    got = _glom(sp.quantile(p, q))
    np.testing.assert_allclose(got, np.quantile(a, q), rtol=1e-12)
    np.testing.assert_allclose(got, _glom(ref.quantile(r, q)), rtol=1e-12)
  a2 = rng.standard_normal((8, 16))
  np.testing.assert_allclose(
      _glom(sp.quantile(sp.from_numpy(a2), [0.1, 0.9], axis=1)),
      np.quantile(a2, [0.1, 0.9], axis=1), rtol=1e-12)


def test_partition_contract(rng):
  a = rng.standard_normal(33)
  k = 7
  got = _glom(sp.partition(sp.from_numpy(a), k))
  want_val = np.partition(a, k)[k]
  assert got[k] == want_val
  assert (got[:k] <= got[k]).all() and (got[k:] >= got[k]).all()
  gi = _glom(sp.argpartition(sp.from_numpy(a), k))
  assert a[gi[k]] == want_val


def test_sort_sharded_lowering_documented(rng):
  """What a sort lowers to on the port's mesh of p logical shards of one
  device: the reference's gather lowering, one stable ``torch.sort`` of
  the whole array, with no sample route (the sample sort exchanges
  buckets between devices)."""
  calls = []
  real = torch.sort

  def spy(*a, **k):
    calls.append(k.get("stable"))
    return real(*a, **k)

  big = rng.standard_normal(1 << 18)
  with sp.with_mesh(sp.make_mesh("cpu", shape=(8,))):
    torch.sort = spy
    try:
      got = _glom(sp.sort(sp.from_numpy(big)))
    finally:
      torch.sort = real
  np.testing.assert_array_equal(got, np.sort(big))
  assert calls and all(calls)


def test_percentile_matches_numpy_sharded(rng):
  a = rng.standard_normal((1 << 14,))
  with sp.with_mesh(sp.make_mesh("cpu", shape=(8,))):
    for q in (0, 10, 50, 99.5, 100):
      np.testing.assert_allclose(float(sp.percentile(sp.from_numpy(a),
                                                     q).glom()),
                                 np.percentile(a, q), atol=1e-12)
