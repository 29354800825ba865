"""The port's constructors and index helpers of ``expr/builtins.py``
(``CreationExpr``'s eye, tri, linspace, window and randint kinds, the
``*_like`` constructors, ``meshgrid``, ``indices``, the triangle and
diagonal index helpers, ``unravel_index``/``ravel_multi_index``) against
the reference and NumPy.

Tolerances: exact for integer, bool and index results and for ``eye``,
``tri``, the ``*_like`` constructors and ``meshgrid``; ``linspace`` is
NumPy's float64 computation (``i * step + start``, the last element
``stop``) and held to it exactly, and to the reference at 1e-10 (XLA
computes its own way); ``logspace``/``geomspace`` and the windows (a
power and cosines) at rtol 1e-10 to NumPy.  The random stream of
``randint`` is not ``jax.random``'s (ROADMAP's Watch list): its range,
dtype and shape are tested.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _same(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  np.testing.assert_array_equal(got, want)


def _glom(x):
  return np.asarray(x.glom())


A = np.random.default_rng(0).uniform(-2, 2, (3, 5))

# name → (port call, NumPy's value, the reference's call or None)
CASES = {
    "empty": (lambda m: m.empty((2, 3)), np.zeros((2, 3))),
    "empty_like": (lambda m: m.empty_like(m.from_numpy(A)), np.zeros_like(A)),
    "zeros_like": (lambda m: m.zeros_like(m.from_numpy(A)), np.zeros_like(A)),
    "ones_like": (lambda m: m.ones_like(m.from_numpy(A)), np.ones_like(A)),
    "full_like": (lambda m: m.full_like(m.from_numpy(A), 2.5),
                  np.full_like(A, 2.5)),
    "eye": (lambda m: m.eye(4, 6, k=1), np.eye(4, 6, k=1)),
    "identity": (lambda m: m.identity(5), np.identity(5)),
    "tri": (lambda m: m.tri(4, 5, k=-1), np.tri(4, 5, k=-1)),
    "ndarray": (lambda m: m.ndarray((2, 2)), np.zeros((2, 2))),
    "asarray": (lambda m: m.asarray(A, dtype=np.float32),
                np.asarray(A, np.float32)),
    "array": (lambda m: m.array(A), np.array(A)),
    "as_array": (lambda m: m.as_array(A), A),
    "indices": (lambda m: m.indices((2, 3)), np.indices((2, 3))),
    "fromfunction": (lambda m: m.fromfunction(lambda i, j: i * 10 + j,
                                               (3, 4)),
                     np.fromfunction(lambda i, j: i * 10 + j, (3, 4))),
    "fromiter": (lambda m: m.fromiter((k * k for k in range(6)), np.int32),
                 np.fromiter((k * k for k in range(6)), np.int32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_constructor_against_numpy_and_the_reference(name):
  port_fn, want = CASES[name]
  got = _glom(port_fn(sp))
  _same(got, want)
  r = _glom(port_fn(ref))
  np.testing.assert_array_equal(got, r.astype(got.dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_creation_dtypes(dtype):
  assert _glom(sp.eye(3, dtype=dtype)).dtype == dtype
  assert _glom(sp.zeros_like(sp.from_numpy(A.astype(dtype)))).dtype == dtype
  _same(_glom(sp.tri(3, dtype=dtype)), np.tri(3, dtype=dtype))


@pytest.mark.parametrize("start, stop, num", [(0.0, 1.0, 50), (-3.3, 7.1, 101),
                                              (5.0, 5.0, 7), (1.0, -2.0, 1),
                                              (0.0, 1.0, 0), (1e-3, 1e3, 33)])
def test_linspace(start, stop, num):
  got = _glom(sp.linspace(start, stop, num))
  want = np.linspace(start, stop, num)
  _same(got, want)
  if num:
    assert got[-1] == want[-1]
  r = _glom(ref.linspace(start, stop, num))
  np.testing.assert_allclose(got, r, rtol=1e-10, atol=1e-12)
  _same(_glom(sp.linspace(start, stop, num, dtype=np.float32)),
        np.linspace(start, stop, num, dtype=np.float32))


@pytest.mark.parametrize("name", ["logspace", "geomspace"])
def test_log_and_geometric_spaces(name):
  if name == "logspace":
    got = _glom(sp.logspace(-2.0, 3.0, 17))
    want = np.logspace(-2.0, 3.0, 17)
    r = _glom(ref.logspace(-2.0, 3.0, 17))
  else:
    got = _glom(sp.geomspace(1e-3, 1e4, 19))
    want = np.geomspace(1e-3, 1e4, 19)
    r = _glom(ref.geomspace(1e-3, 1e4, 19))
    assert got[0] == 1e-3 and got[-1] == 1e4
    np.testing.assert_allclose(_glom(sp.geomspace(-8.0, -1.0, 4)),
                               np.geomspace(-8.0, -1.0, 4), rtol=1e-10)
  assert got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=1e-10)
  np.testing.assert_allclose(got, r, rtol=1e-10)


@pytest.mark.parametrize("m", [0, 1, 2, 7, 12])
@pytest.mark.parametrize("name", ["bartlett", "blackman", "hamming",
                                  "hanning", "kaiser"])
def test_windows(name, m):
  args = (m, 4.5) if name == "kaiser" else (m,)
  got = _glom(getattr(sp, name)(*args))
  want = getattr(np, name)(*args)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-15)
  r = _glom(getattr(ref, name)(*args))
  np.testing.assert_allclose(got, r, rtol=1e-10, atol=1e-15)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_randint_range_dtype_and_shape(dtype):
  got = _glom(sp.randint(-3, 9, size=(40, 50), dtype=dtype))
  assert got.dtype == dtype and got.shape == (40, 50)
  assert got.min() >= -3 and got.max() < 9
  assert len(np.unique(got)) == 12  # 2000 draws reach every value
  one = _glom(sp.randint(5, size=7))
  assert one.shape == (7,) and one.min() >= 0 and one.max() < 5
  r = _glom(ref.randint(-3, 9, size=(40, 50), dtype=dtype))
  assert r.shape == got.shape and r.min() >= -3 and r.max() < 9


def test_from_dlpack():
  t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
  _same(_glom(sp.from_dlpack(t)), t.numpy())


@pytest.mark.parametrize("indexing", ["xy", "ij"])
def test_meshgrid(indexing):
  x, y, z = np.arange(3.0), np.linspace(0, 1, 4), np.arange(2)
  got = sp.meshgrid(sp.from_numpy(x), y, z, indexing=indexing)
  want = np.meshgrid(x, y, z, indexing=indexing)
  assert isinstance(got, list) and len(got) == 3
  for g, w in zip(got, want):
    _same(_glom(g), w)
  for g, r in zip(got, ref.meshgrid(x, y, z, indexing=indexing)):
    np.testing.assert_array_equal(_glom(g), _glom(r))


def test_ix():
  rows, cols = np.array([0, 2]), np.array([1, 3, 4])
  got = sp.ix_(sp.from_numpy(rows), sp.from_numpy(cols))
  want = np.ix_(rows, cols)
  for g, w in zip(got, want):
    _same(_glom(g), w)
  picked = sp.from_numpy(A)[got].glom()
  np.testing.assert_array_equal(picked, A[want])
  with pytest.raises(ValueError):
    sp.ix_(sp.from_numpy(A))


INDEX_HELPERS = {
    "diag_indices": (lambda m: m.diag_indices(4, 3),
                     np.diag_indices(4, 3)),
    "diag_indices_from": (lambda m: m.diag_indices_from(m.from_numpy(
        np.zeros((3, 3)))), np.diag_indices_from(np.zeros((3, 3)))),
    "tril_indices": (lambda m: m.tril_indices(4, -1, 5),
                     np.tril_indices(4, -1, 5)),
    "triu_indices": (lambda m: m.triu_indices(4, 1), np.triu_indices(4, 1)),
    "tril_indices_from": (lambda m: m.tril_indices_from(m.from_numpy(A)),
                          np.tril_indices_from(A)),
    "triu_indices_from": (lambda m: m.triu_indices_from(m.from_numpy(A), 2),
                          np.triu_indices_from(A, 2)),
    "mask_indices": (lambda m: m.mask_indices(4, np.triu, 1),
                     np.mask_indices(4, np.triu, 1)),
    "unravel_index": (lambda m: m.unravel_index(np.array([0, 7, 11, 23]),
                                                (2, 3, 4)),
                      np.unravel_index(np.array([0, 7, 11, 23]), (2, 3, 4))),
}


@pytest.mark.parametrize("name", sorted(INDEX_HELPERS))
def test_index_helpers(name):
  port_fn, want = INDEX_HELPERS[name]
  got = port_fn(sp)
  assert isinstance(got, tuple) and len(got) == len(want)
  for g, w in zip(got, want):
    _same(_glom(g), w.astype(np.int64))
  for g, r in zip(got, port_fn(ref)):
    np.testing.assert_array_equal(_glom(g), _glom(r))


def test_index_helpers_refuse_bad_input():
  with pytest.raises(ValueError):
    sp.diag_indices_from(sp.from_numpy(A))
  with pytest.raises(ValueError):
    sp.tril_indices_from(sp.from_numpy(np.zeros(3)))
  with pytest.raises(ValueError):
    sp.unravel_index(np.array([24]), (2, 3, 4))


@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_ravel_multi_index(mode):
  rows, cols = np.array([0, 1, 2, 5, -1]), np.array([3, 0, 9, 1, 2])
  got = _glom(sp.ravel_multi_index((sp.from_numpy(rows), cols), (3, 4),
                                   mode=mode))
  want = np.ravel_multi_index((rows, cols), (3, 4), mode=mode)
  _same(got, want.astype(np.int64))
  r = _glom(ref.ravel_multi_index((rows, cols), (3, 4), mode=mode))
  np.testing.assert_array_equal(got, r)
  with pytest.raises(ValueError):
    sp.ravel_multi_index((rows, cols), (3, 4), mode="raise")


def test_broadcast_shapes():
  assert sp.broadcast_shapes((3, 1), (1, 4), (4,)) == np.broadcast_shapes(
      (3, 1), (1, 4), (4,)) == ref.broadcast_shapes((3, 1), (1, 4), (4,))
  with pytest.raises(ValueError):
    sp.broadcast_shapes((3,), (4,))


def test_creation_fuses_into_its_region():
  """``eye`` and ``linspace`` are creation nodes, emitted inside the
  region that reads them (no leaf is made for them)."""
  from spartan_tpu_torch.expr.ndarray import CreationExpr
  e = sp.eye(4) * 2.0 + sp.linspace(0, 1, 4)
  assert any(isinstance(c, CreationExpr) for c in e.inputs)
  np.testing.assert_array_equal(_glom(e), np.eye(4) * 2.0 + np.linspace(
      0, 1, 4))
