"""``ConcatenateExpr``, ``StackExpr`` and ``TileExpr`` and the
builtins on them (``concatenate`` … ``dsplit``), ``TupleExpr`` and
``DictExpr``, and the helpers of ``util``, ``core.array.create`` and
``core.mesh.replicated`` — against NumPy and the reference.

Everything is held exactly: joins, splits and tiles copy values.  The
joins promote as NumPy does (int32 with float32 gives float64, where
torch's ``cat`` gives float32).  Pinned (ROADMAP): ``vstack`` of a 1-D
and a 2-D array follows NumPy (a ``(3, n)`` result) where the reference
raises, since it looks at the first array's rank only; ``split`` and its
kin return lists of slice exprs, as the reference does.
"""

import logging

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu import util as ref_util

import spartan_tpu_torch as sp
from spartan_tpu_torch import util
from spartan_tpu_torch.backend import evaluator
from spartan_tpu_torch.core import array as array_mod
from spartan_tpu_torch.core import mesh as mesh_mod
from spartan_tpu_torch.expr.reshape import (ConcatenateExpr, StackExpr,
                                            TileExpr)


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(18)
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


# name → call over a module m and arrays a, b (4x5 each)
JOINS = {
    "concatenate_0": lambda m, a, b: m.concatenate([a, b]),
    "concatenate_1": lambda m, a, b: m.concatenate([a, b, a], axis=1),
    "concatenate_neg": lambda m, a, b: m.concatenate([a, b[:2]], axis=-2),
    "concatenate_none": lambda m, a, b: m.concatenate([a, b[0]], axis=None),
    "concat": lambda m, a, b: m.concat([a, b], axis=1),
    "stack_0": lambda m, a, b: m.stack([a, b]),
    "stack_last": lambda m, a, b: m.stack([a, b], axis=-1),
    "vstack": lambda m, a, b: m.vstack([a, b]),
    "vstack_1d": lambda m, a, b: m.vstack([a[0], b[1], a[2]]),
    "hstack": lambda m, a, b: m.hstack([a, b]),
    "hstack_1d": lambda m, a, b: m.hstack([a[0], b[1]]),
    "dstack": lambda m, a, b: m.dstack([a, b]),
    "dstack_1d": lambda m, a, b: m.dstack([a[0], b[0]]),
    "column_stack": lambda m, a, b: m.column_stack([a[0], b[0]]),
    "column_stack_2d": lambda m, a, b: m.column_stack([a, b[:, 0]]),
    "tile_int": lambda m, a, b: m.tile(a, 2),
    "tile_pair": lambda m, a, b: m.tile(a, (2, 1)),
    "tile_more": lambda m, a, b: m.tile(a, (1, 2, 3)),
    "tile_zero": lambda m, a, b: m.tile(a, (0, 2)),
    "append_flat": lambda m, a, b: m.append(a, b[0]),
    "append_axis": lambda m, a, b: m.append(a, b, axis=0),
    "block_2x2": lambda m, a, b: m.block([[a, b], [b, a]]),
    "block_1d": lambda m, a, b: m.block([a[0], b[0]]),
    "block_mixed_rank": lambda m, a, b: m.block([[a, b[:, :2]],
                                                 [b[:1, :], a[:1, :2]]]),
    "roll_flat": lambda m, a, b: m.roll(a, 3),
    "roll_axis": lambda m, a, b: m.roll(a, -2, axis=1),
    "roll_two": lambda m, a, b: m.roll(a, (1, 2), axis=(0, 1)),
    "roll_same_axis": lambda m, a, b: m.roll(a, (1, 2), axis=(1, 1)),
}
NP = {
    "concatenate_0": lambda a, b: np.concatenate([a, b]),
    "concatenate_1": lambda a, b: np.concatenate([a, b, a], axis=1),
    "concatenate_neg": lambda a, b: np.concatenate([a, b[:2]], axis=-2),
    "concatenate_none": lambda a, b: np.concatenate([a, b[0]], axis=None),
    "concat": lambda a, b: np.concat([a, b], axis=1),
    "stack_0": lambda a, b: np.stack([a, b]),
    "stack_last": lambda a, b: np.stack([a, b], axis=-1),
    "vstack": lambda a, b: np.vstack([a, b]),
    "vstack_1d": lambda a, b: np.vstack([a[0], b[1], a[2]]),
    "hstack": lambda a, b: np.hstack([a, b]),
    "hstack_1d": lambda a, b: np.hstack([a[0], b[1]]),
    "dstack": lambda a, b: np.dstack([a, b]),
    "dstack_1d": lambda a, b: np.dstack([a[0], b[0]]),
    "column_stack": lambda a, b: np.column_stack([a[0], b[0]]),
    "column_stack_2d": lambda a, b: np.column_stack([a, b[:, 0]]),
    "tile_int": lambda a, b: np.tile(a, 2),
    "tile_pair": lambda a, b: np.tile(a, (2, 1)),
    "tile_more": lambda a, b: np.tile(a, (1, 2, 3)),
    "tile_zero": lambda a, b: np.tile(a, (0, 2)),
    "append_flat": lambda a, b: np.append(a, b[0]),
    "append_axis": lambda a, b: np.append(a, b, axis=0),
    "block_2x2": lambda a, b: np.block([[a, b], [b, a]]),
    "block_1d": lambda a, b: np.block([a[0], b[0]]),
    "block_mixed_rank": lambda a, b: np.block([[a, b[:, :2]],
                                               [b[:1, :], a[:1, :2]]]),
    "roll_flat": lambda a, b: np.roll(a, 3),
    "roll_axis": lambda a, b: np.roll(a, -2, axis=1),
    "roll_two": lambda a, b: np.roll(a, (1, 2), axis=(0, 1)),
    "roll_same_axis": lambda a, b: np.roll(a, (1, 2), axis=(1, 1)),
}
PAIRS = {"float64": ("float64", "float64"), "mixed": ("int32", "float32"),
         "int_bool": ("int32", "bool"), "bool": ("bool", "bool")}
# the reference's joins over jnp (dstack, column_stack, block, roll) keep
# jnp's promotion; the rest are its own
REF_SKIP = {"vstack_1d_mixed"}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("name", sorted(JOINS))
def test_joins_against_numpy_and_the_reference(name, pair):
  a, b = (DATA[k] for k in PAIRS[pair])
  got = _glom(JOINS[name](sp, sp.from_numpy(a), sp.from_numpy(b)))
  _same(got, NP[name](a, b))
  if pair in ("float64", "int_bool") and name not in ("vstack_1d",
                                                      "block_mixed_rank"):
    r = _glom(JOINS[name](ref, ref.from_numpy(a), ref.from_numpy(b)))
    np.testing.assert_array_equal(got, r)


@pytest.mark.parametrize("name, cls", [("concatenate", ConcatenateExpr),
                                       ("stack", StackExpr)])
def test_the_joins_are_nodes_of_their_own(name, cls):
  a = sp.from_numpy(DATA["int32"])
  e = getattr(sp, name)([a, a])
  assert isinstance(e, cls)
  assert isinstance(sp.tile(a, 2), TileExpr)
  # the join feeds a region like any node
  got = _glom(getattr(sp, name)([a, a]) * 2 + 1)
  _same(got, getattr(np, name)([DATA["int32"]] * 2) * 2 + 1)


def test_vstack_of_mixed_ranks_follows_numpy_where_the_reference_raises():
  a, b = DATA["float64"][0], DATA["float64"][1:3]
  _same(_glom(sp.vstack([sp.from_numpy(a), sp.from_numpy(b)])),
        np.vstack([a, b]))
  assert np.vstack([a, b]).shape == (3, 5)
  with pytest.raises(ValueError, match="same shape"):
    ref.vstack([ref.from_numpy(a), ref.from_numpy(b)]).glom()


def test_joins_refuse_what_numpy_refuses():
  a = sp.from_numpy(DATA["float64"])
  with pytest.raises(ValueError, match="zero-dimensional"):
    sp.concatenate([sp.from_numpy(np.array(1.0))] * 2)
  with pytest.raises(ValueError, match="must match exactly"):
    sp.concatenate([a, a[:, :2]], axis=0)
  with pytest.raises(ValueError, match="same number of dimensions"):
    sp.concatenate([a, a[0]])
  with pytest.raises(ValueError, match="same shape"):
    sp.stack([a, a[:2]])
  with pytest.raises(np.exceptions.AxisError):
    sp.concatenate([a, a], axis=2)
  with pytest.raises(ValueError, match="need at least one"):
    sp.concatenate([])
  with pytest.raises(TypeError, match="tuple"):
    sp.block((a, a))
  with pytest.raises(ValueError, match="depths are mismatched"):
    sp.block([[a], a])


INSERTS = [(2, 9.5, None), (1, [7, 8, 9, 1], 1), ([0, 2, 2], [[5], [6], [7]], 0),
           (slice(0, 4, 2), 3, 1), (-1, [1, 2, 3, 4, 5], 0),
           ([1], [[1], [2], [3], [4]], 1), (4, 2.9, 0)]


@pytest.mark.parametrize("kind", ["float64", "int32"])
@pytest.mark.parametrize("case", range(len(INSERTS)))
def test_insert(case, kind):
  obj, vals, axis = INSERTS[case]
  x = DATA[kind]
  _same(_glom(sp.insert(sp.from_numpy(x), obj, vals, axis=axis)),
        np.insert(x, obj, vals, axis=axis))
  if kind == "float64" and not isinstance(obj, slice):
    np.testing.assert_array_equal(
        _glom(sp.insert(sp.from_numpy(x), obj, vals, axis=axis)),
        _glom(ref.insert(ref.from_numpy(x), obj, vals, axis=axis)))


DELETES = [(2, None), (slice(1, 5, 2), 1), ([0, -1], 0),
           (np.array([True, False, True, False]), 0), (-2, 1), ([], 1)]


@pytest.mark.parametrize("kind", ["float64", "bool"])
@pytest.mark.parametrize("case", range(len(DELETES)))
def test_delete(case, kind):
  obj, axis = DELETES[case]
  x = DATA[kind]
  _same(_glom(sp.delete(sp.from_numpy(x), obj, axis=axis)),
        np.delete(x, obj, axis=axis))
  if kind == "float64" and isinstance(obj, int):
    _same(_glom(sp.delete(sp.from_numpy(x), obj, axis=axis)),
          _glom(ref.delete(ref.from_numpy(x), obj, axis=axis)))


def test_insert_and_delete_refuse_out_of_bounds():
  x = sp.from_numpy(DATA["float64"])
  with pytest.raises(IndexError):
    sp.insert(x, 5, 1.0, axis=0)
  with pytest.raises(IndexError):
    sp.delete(x, 4, axis=0)
  with pytest.raises(ValueError, match="boolean array"):
    sp.delete(x, np.array([True, False]), axis=0)


SPLITS = [("split", 2, 0, False), ("split", [1, 3], 1, False),
          ("split", 3, 1, True), ("array_split", 3, 1, False),
          ("array_split", [4, 1, 10], 1, False), ("array_split", [-2], 0,
                                                  False),
          ("array_split", 7, 0, False), ("hsplit", 5, None, False),
          ("vsplit", 2, None, False), ("dsplit", [1, 3], None, False)]


@pytest.mark.parametrize("case", range(len(SPLITS)))
def test_splits_are_lists_of_slices(case):
  name, ios, axis, raises = SPLITS[case]
  x = T3 if name == "dsplit" else DATA["float64"]
  args = (ios,) if axis is None else (ios, axis)
  if raises:
    with pytest.raises(ValueError, match="equal division"):
      getattr(sp, name)(sp.from_numpy(x), *args)
    return
  got = getattr(sp, name)(sp.from_numpy(x), *args)
  want = getattr(np, name)(x, *args)
  assert isinstance(got, list) and len(got) == len(want)
  for g, w in zip(got, want):
    _same(_glom(g), w)
  if name in ("split", "array_split", "hsplit", "vsplit"):
    for g, r in zip(got, getattr(ref, name)(ref.from_numpy(x), *args)):
      _same(_glom(g), _glom(r))


def test_split_refusals():
  with pytest.raises(ValueError, match="larger than 0"):
    sp.array_split(sp.from_numpy(DATA["float64"]), 0)
  with pytest.raises(ValueError, match="vsplit"):
    sp.vsplit(sp.from_numpy(DATA["float64"][0]), 1)
  with pytest.raises(ValueError, match="dsplit"):
    sp.dsplit(sp.from_numpy(DATA["float64"]), 1)
  with pytest.raises(ValueError, match="hsplit"):
    sp.hsplit(sp.from_numpy(np.array(1.0)), 1)


# -- TupleExpr and DictExpr ----------------------------------------------------------

def test_tuple_and_dict_exprs_evaluate_in_one_region():
  a = sp.from_numpy(DATA["float64"])
  members = [a.sum(axis=0), (a * 2).max(), sp.concatenate([a, a]).mean()]
  evaluator.clear_cache()
  before = evaluator.stats["compiles"]
  out = sp.evaluate(sp.TupleExpr(members))
  assert evaluator.stats["compiles"] == before + 1
  d = sp.evaluate(sp.DictExpr({"s": a.sum(), "m": a.mean(),
                               "t": sp.tile(a, 2)}))
  assert evaluator.stats["compiles"] == before + 2
  assert isinstance(out, list) and len(out) == 3
  for got, m in zip(out, members):
    _same(got.glom(), _glom(m))
  assert sorted(d) == ["m", "s", "t"]
  _same(d["s"].glom(), _glom(a.sum()))
  _same(d["m"].glom(), _glom(a.mean()))
  _same(d["t"].glom(), np.tile(DATA["float64"], 2))
  e = sp.DictExpr({"s": a.sum()})
  assert e["s"] is e.vals[0]
  r = ref.evaluate(ref.DictExpr({"s": ref.from_numpy(DATA["float64"]).sum()}))
  np.testing.assert_allclose(d["s"].glom(), np.asarray(r["s"].glom()),
                             rtol=1e-15)
  assert isinstance(sp.TupleExpr(members), sp.ListExpr)


# -- util, core.array.create, core.mesh.replicated -----------------------------------

def test_divup_and_memoize_as_the_reference():
  for a, b in ((7, 2), (8, 2), (0, 3), (1, 5), (-7, 2)):
    assert util.divup(a, b) == ref_util.divup(a, b)
  calls = []

  @util.memoize
  def square(x):
    calls.append(x)
    return x * x

  assert [square(3), square(3), square(4)] == [9, 9, 16]
  assert calls == [3, 4] and square.cache == {(3,): 9, (4,): 16}


def test_timeit_and_the_logging_helpers(caplog):
  with util.timeit("block", log=False) as t:
    sum(range(1000))
  assert t["elapsed"] is not None and t["elapsed"] >= 0.0
  logger = logging.getLogger("spartan_tpu_torch")
  logger.propagate = True
  try:
    util.set_log_level(logging.INFO)
    with caplog.at_level(logging.INFO, logger="spartan_tpu_torch"):
      with util.timeit("the block"):
        pass
      util.log_warn("careful %d", 3)
      util.log_error("broken %s", "x")
  finally:
    logger.propagate = False
    util.set_log_level(logging.WARNING)
  text = caplog.text
  assert "the block took" in text and "careful 3" in text
  assert "broken x" in text
  levels = {r.getMessage(): r.levelno for r in caplog.records}
  assert levels["careful 3"] == logging.WARNING
  assert levels["broken x"] == logging.ERROR


def test_assert_helpers_as_the_reference():
  x = sp.from_numpy(DATA["float64"])
  for helper in (util.Assert, ref_util.Assert):
    helper.all_eq(x.glom(), DATA["float64"])
    helper.all_close(DATA["float64"] + 1e-12, DATA["float64"])
    helper.eq(3, 3)
    helper.true(True)
    helper.isinstance(1.0, float)
    with pytest.raises(AssertionError):
      helper.all_eq(DATA["float64"], DATA["float64"] + 1e-6)
    with pytest.raises(AssertionError):
      helper.eq(1, 2)
  util.Assert.all_eq(x, DATA["float64"])  # an expr is fetched first
  util.Assert.all_eq(sp.concatenate([x, x]), np.concatenate(
      [DATA["float64"]] * 2))


@pytest.mark.parametrize("dtype, fill", [(np.float64, 0), (np.float32, 2.5),
                                         (np.int32, 7), (np.bool_, True)])
def test_create_fills_on_the_meshs_device(dtype, fill):
  arr = array_mod.create((3, 4), dtype=dtype, fill=fill)
  assert arr.shape == (3, 4)
  assert arr.device == sp.get_mesh().device
  _same(arr.glom(), np.full((3, 4), fill, dtype=dtype))
  r = ref.core.array.create((3, 4), dtype=dtype, fill=fill)
  _same(arr.glom(), np.asarray(r.glom()))
  mesh = sp.make_mesh("cpu", shape=(2,))
  assert array_mod.create((2,), mesh=mesh).tiling.mesh == mesh


def test_replicated_is_the_empty_spec_on_the_mesh():
  placement = mesh_mod.replicated()
  assert placement.spec == () and placement.mesh == sp.get_mesh()
  assert tuple(ref.core.mesh.replicated().spec) == placement.spec
  mesh = sp.make_mesh("cpu", shape=(2, 2))
  assert mesh_mod.replicated(mesh).mesh == mesh
  assert mesh_mod.replicated(mesh).extents((4, 4))[0].shape == (4, 4)
