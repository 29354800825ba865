"""The port's shape helpers (``atleast_1d`` … ``pad``) against NumPy and
the reference, and the optimizer's rule for maps that are not
elementwise.

Every result is held exactly (shape, dtype and values), except ``pad``'s
``mean`` mode of float data: NumPy's mean and torch's add in other
orders, 1e-12 (float64) and 1e-6 (float32) of the largest value.
``matrix_transpose``, ``permute_dims``, ``rollaxis`` and ``moveaxis`` are
``TransposeExpr`` nodes.  ``pad`` is NumPy's algorithm (axis by axis,
the earlier axes' pad areas included) on a buffer on the device, in
every mode ``np.pad`` has; the reference passes each to ``jnp.pad``.
``broadcast_to`` is a view with zero strides inside the region: a
write (``.at``, a scatter) into its result writes a clone, and the
source is untouched.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr.map import MapExpr
from spartan_tpu_torch.expr.reshape import TransposeExpr


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(17)
DATA = {"float64": RNG.standard_normal((4, 5)),
        "float32": RNG.standard_normal((4, 5)).astype(np.float32),
        "int32": RNG.integers(-9, 10, (4, 5)).astype(np.int32),
        "bool": RNG.random((4, 5)) < 0.5}
T3 = RNG.standard_normal((2, 3, 4))


def _glom(x):
  return np.asarray(x.glom())


def _same(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  np.testing.assert_array_equal(got, want)


CASES = {
    "atleast_1d_0d": lambda m, x: m.atleast_1d(x[0, 0]),
    "atleast_2d_1d": lambda m, x: m.atleast_2d(x[0]),
    "atleast_2d_2d": lambda m, x: m.atleast_2d(x),
    "atleast_3d_1d": lambda m, x: m.atleast_3d(x[0]),
    "atleast_3d_2d": lambda m, x: m.atleast_3d(x),
    "broadcast_to": lambda m, x: m.broadcast_to(x[0], (3, 5)),
    "broadcast_to_col": lambda m, x: m.broadcast_to(x[:, :1], (2, 4, 5)),
    "flip_all": lambda m, x: m.flip(x),
    "flip_0": lambda m, x: m.flip(x, 0),
    "flip_neg": lambda m, x: m.flip(x, -1),
    "fliplr": lambda m, x: m.fliplr(x),
    "flipud": lambda m, x: m.flipud(x),
    "matrix_transpose": lambda m, x: m.matrix_transpose(x),
    "moveaxis": lambda m, x: m.moveaxis(x, 0, -1),
    "permute_dims": lambda m, x: m.permute_dims(x, (1, 0)),
    "rollaxis": lambda m, x: m.rollaxis(x, 1),
    "rot90": lambda m, x: m.rot90(x),
    "rot90_k3": lambda m, x: m.rot90(x, 3, (1, 0)),
    "rot90_k2": lambda m, x: m.rot90(x, -2),
}
NP = {"atleast_1d_0d": lambda x: np.atleast_1d(x[0, 0]),
      "atleast_2d_1d": lambda x: np.atleast_2d(x[0]),
      "atleast_2d_2d": np.atleast_2d,
      "atleast_3d_1d": lambda x: np.atleast_3d(x[0]),
      "atleast_3d_2d": np.atleast_3d,
      "broadcast_to": lambda x: np.broadcast_to(x[0], (3, 5)),
      "broadcast_to_col": lambda x: np.broadcast_to(x[:, :1], (2, 4, 5)),
      "flip_all": np.flip, "flip_0": lambda x: np.flip(x, 0),
      "flip_neg": lambda x: np.flip(x, -1), "fliplr": np.fliplr,
      "flipud": np.flipud, "matrix_transpose": np.matrix_transpose,
      "moveaxis": lambda x: np.moveaxis(x, 0, -1),
      "permute_dims": lambda x: np.permute_dims(x, (1, 0)),
      "rollaxis": lambda x: np.rollaxis(x, 1), "rot90": np.rot90,
      "rot90_k3": lambda x: np.rot90(x, 3, (1, 0)),
      "rot90_k2": lambda x: np.rot90(x, -2)}


@pytest.mark.parametrize("kind", sorted(DATA))
@pytest.mark.parametrize("name", sorted(CASES))
def test_against_numpy_and_the_reference(name, kind):
  x = DATA[kind]
  got = _glom(CASES[name](sp, sp.from_numpy(x)))
  _same(got, NP[name](x))
  if kind in ("float64", "int32"):
    _same(got, _glom(CASES[name](ref, ref.from_numpy(x))))


@pytest.mark.parametrize("case", [(0, -1), ([0, 1], [-1, 0]), (2, 0),
                                  ((0, 2), (2, 0))])
def test_moveaxis_is_a_transpose(case):
  e = sp.moveaxis(sp.from_numpy(T3), *case)
  assert isinstance(e, TransposeExpr)
  _same(_glom(e), np.moveaxis(T3, *case))


@pytest.mark.parametrize("axis, start", [(2, 0), (0, 3), (1, -1), (-1, 1),
                                         (0, 0), (2, 3)])
def test_rollaxis_is_a_transpose(axis, start):
  e = sp.rollaxis(sp.from_numpy(T3), axis, start)
  assert isinstance(e, TransposeExpr)
  _same(_glom(e), np.rollaxis(T3, axis, start))
  _same(_glom(e), _glom(ref.rollaxis(ref.from_numpy(T3), axis, start)))


def test_shape_helpers_refuse_what_numpy_refuses():
  v = sp.from_numpy(DATA["float64"][0])
  with pytest.raises(ValueError):
    sp.fliplr(v)
  with pytest.raises(ValueError):
    sp.matrix_transpose(v)
  with pytest.raises(ValueError):
    sp.broadcast_to(sp.from_numpy(DATA["float64"]), (3, 5))
  with pytest.raises(ValueError, match="different"):
    sp.rot90(sp.from_numpy(T3), 1, (0, 0))
  with pytest.raises(np.exceptions.AxisError):
    sp.rollaxis(sp.from_numpy(T3), 0, 5)
  with pytest.raises(ValueError, match="repeated"):
    sp.moveaxis(sp.from_numpy(T3), [0, 0], [1, 2])


def test_atleast_of_several_is_a_tuple_and_matrix_transpose_a_transpose():
  a, b = sp.atleast_3d(np.array(1.0), DATA["float64"][0])
  _same(_glom(a), np.atleast_3d(np.array(1.0)))
  _same(_glom(b), np.atleast_3d(DATA["float64"][0]))
  assert isinstance(sp.matrix_transpose(sp.from_numpy(T3)), TransposeExpr)
  _same(_glom(sp.matrix_transpose(sp.from_numpy(T3))),
        np.matrix_transpose(T3))


def test_broadcast_arrays():
  x, y = DATA["float64"][0], DATA["int32"][:, :1]
  got = sp.broadcast_arrays(sp.from_numpy(x), sp.from_numpy(y))
  for g, w in zip(got, np.broadcast_arrays(x, y)):
    _same(_glom(g), w)


def test_writes_into_a_broadcast_result_clone_it():
  v = DATA["float64"][0]
  b = sp.broadcast_to(sp.from_numpy(v), (3, 5))
  arr = b.evaluate()
  assert arr.data.stride() == (0, 1)  # a view inside the region
  set_one = b.at[1, 2].set(100.0)
  added = b.at[sp.from_numpy(np.array([0, 2, 0]))].add(1.0)
  want = np.broadcast_to(v, (3, 5)).copy()
  want[1, 2] = 100.0
  _same(_glom(set_one), want)
  want = np.broadcast_to(v, (3, 5)).copy()
  np.add.at(want, [0, 2, 0], 1.0)
  _same(_glom(added), want)
  _same(_glom(b), np.broadcast_to(v, (3, 5)))
  _same(arr.glom(), np.broadcast_to(v, (3, 5)))
  # the fused-reduce kernel's plain version reads a contiguous copy
  f32 = DATA["float32"][0]
  total = float(sp.sum(sp.broadcast_to(sp.from_numpy(f32), (64, 5))).glom())
  assert total == pytest.approx(64 * f32.astype(np.float64).sum(), rel=1e-12)


def test_apply_over_axes():
  for axes in ([0, 2], 1, [-1]):
    got = _glom(sp.apply_over_axes(sp.sum, sp.from_numpy(T3), axes))
    want = np.apply_over_axes(np.sum, T3, axes)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    np.testing.assert_allclose(
        got, _glom(ref.apply_over_axes(ref.sum, ref.from_numpy(T3), axes)),
        rtol=1e-13)
  with pytest.raises(ValueError, match="correct shape"):
    sp.apply_over_axes(lambda a, ax: sp.sum(a), sp.from_numpy(T3), [0])


# -- pad: every mode of np.pad -------------------------------------------------------

PAD_MODES = [
    ("constant", {}), ("constant", {"constant_values": ((1, 2), (3, 4))}),
    ("constant", {"constant_values": 7}), ("edge", {}), ("linear_ramp", {}),
    ("linear_ramp", {"end_values": (5, -3)}),
    ("linear_ramp", {"end_values": ((1, 2), (3, 4))}),
    ("maximum", {}), ("maximum", {"stat_length": 2}), ("minimum", {}),
    ("minimum", {"stat_length": ((1, 3), (2, 1))}), ("mean", {}),
    ("mean", {"stat_length": ((1, 2), (3, 1))}), ("median", {}),
    ("median", {"stat_length": 2}), ("reflect", {}),
    ("reflect", {"reflect_type": "odd"}), ("symmetric", {}),
    ("symmetric", {"reflect_type": "odd"}), ("wrap", {}),
]
WIDTHS = {"one": 1, "pair": (2, 3), "wide": ((3, 0), (7, 11))}


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("kind", ["float64", "float32", "int32"])
@pytest.mark.parametrize("mode, kw", PAD_MODES,
                         ids=[f"{m}-{'-'.join(kw) or 'default'}-{i}"
                              for i, (m, kw) in enumerate(PAD_MODES)])
def test_pad_against_numpy(mode, kw, kind, width):
  x = DATA[kind]
  pw = WIDTHS[width]
  got = _glom(sp.pad(sp.from_numpy(x), pw, mode, **kw))
  want = np.pad(x, pw, mode, **kw)
  if mode == "mean" and kind != "int32":
    assert got.dtype == want.dtype
    tol = 1e-6 if kind == "float32" else 1e-12
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))
  else:
    _same(got, want)
  if kind == "float64" and width == "pair":
    r = _glom(ref.pad(ref.from_numpy(x), pw, mode, **kw))
    np.testing.assert_allclose(got, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["reflect", "symmetric", "wrap", "edge",
                                  "constant", "maximum"])
def test_pad_3d_and_singleton_axes(mode):
  pw = ((1, 2), (0, 3), (4, 1))
  _same(_glom(sp.pad(sp.from_numpy(T3), pw, mode)), np.pad(T3, pw, mode))
  one = T3[:, :1, :]
  _same(_glom(sp.pad(sp.from_numpy(one), pw, mode)), np.pad(one, pw, mode))


def test_pad_empty_constant_and_refusals():
  x = DATA["int32"]
  got = _glom(sp.pad(sp.from_numpy(x), 2, "empty"))
  assert got.shape == (8, 9)
  _same(got[2:-2, 2:-2], x)
  _same(_glom(sp.pad(sp.from_numpy(x), 2, constant_values=1.7)),
        np.pad(x, 2, constant_values=1.7))
  empty = np.zeros((0, 3))
  _same(_glom(sp.pad(sp.from_numpy(empty), 1)), np.pad(empty, 1))
  with pytest.raises(ValueError, match="can't extend empty axis"):
    sp.pad(sp.from_numpy(empty), 1, "edge")
  with pytest.raises(ValueError, match="not supported"):
    sp.pad(sp.from_numpy(x), 1, "bogus")
  with pytest.raises(ValueError, match="unsupported keyword"):
    sp.pad(sp.from_numpy(x), 1, "edge", constant_values=3)
  with pytest.raises(TypeError, match="integral"):
    sp.pad(sp.from_numpy(x), 1.5)
  with pytest.raises(ValueError, match="negative"):
    sp.pad(sp.from_numpy(x), -1)
  with pytest.raises(ValueError, match="stat_length of 0"):
    sp.pad(sp.from_numpy(x), 1, "maximum", stat_length=0).glom()


# -- maps that are not elementwise keep their operands whole ---------------------

STRUCTURAL = {
    "take": (lambda m: m.take(m.ones(5), np.array([4, 0, 2, 2, 1])),
             lambda: np.ones(5)[[4, 0, 2, 2, 1]]),
    "kron": (lambda m: m.kron(m.ones((2, 2)), DATA["float64"][:2, :2]),
             lambda: np.kron(np.ones((2, 2)), DATA["float64"][:2, :2])),
    "isin": (lambda m: m.isin(m.ones(5), np.arange(5.0)),
             lambda: np.isin(np.ones(5), np.arange(5.0))),
    "polyadd": (lambda m: m.polyadd(m.ones(3), DATA["float64"][0, :3]),
                lambda: np.polyadd(np.ones(3), DATA["float64"][0, :3])),
    "meshgrid": (lambda m: m.meshgrid(m.ones(3), np.arange(3.0))[0],
                 lambda: np.meshgrid(np.ones(3), np.arange(3.0))[0]),
}


@pytest.mark.parametrize("name", sorted(STRUCTURAL))
def test_a_ones_operand_of_a_structural_map_is_not_folded(name):
  """The optimizer folds ``ones(shape)`` into a scalar only inside an
  elementwise kernel: beside a gather index or in a ``kron`` it is an
  array."""
  call, want = STRUCTURAL[name]
  e = call(sp)
  assert isinstance(e, MapExpr)
  _same(_glom(e), want())
