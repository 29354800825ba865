"""The comparison operators and ufuncs (``<``, ``<=``, ``>``, ``>=``;
``less`` … ``greater_equal``) and ``expand_dims`` against the reference,
exactly (bool results, NumPy promotion), and the fused-reduce kernel's
translator refusing comparisons up front."""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


OPS = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
       ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}
FUNCS = ["less", "less_equal", "greater", "greater_equal"]


def _operands():
  rng = np.random.default_rng(3)
  f = np.round(rng.standard_normal((6, 5)), 1)
  i = rng.integers(-2, 3, (6, 5))
  return f, i


@pytest.mark.parametrize("pair", ["float-float", "float-int", "int-scalar",
                                  "scalar-float", "row-broadcast"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_comparison_operators_match_reference(op, pair):
  f, i = _operands()
  fn = OPS[op]
  lhs, rhs = {"float-float": (f, f[::-1].copy()), "float-int": (f, i),
              "int-scalar": (i, 0.5), "scalar-float": (0.0, f),
              "row-broadcast": (f, f[2])}[pair]

  def lift(mod, v):
    return mod.from_numpy(v) if isinstance(v, np.ndarray) else v

  want = np.asarray(fn(lift(ref, lhs), lift(ref, rhs)).glom())
  got = fn(lift(sp, lhs), lift(sp, rhs)).glom()
  assert got.dtype == want.dtype == np.bool_
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, fn(lhs, rhs))


@pytest.mark.parametrize("name", FUNCS)
def test_comparison_ufuncs_match_reference(name):
  f, i = _operands()
  want = np.asarray(getattr(ref, name)(ref.from_numpy(f),
                                       ref.from_numpy(i)).glom())
  got = getattr(sp, name)(sp.from_numpy(f), sp.from_numpy(i)).glom()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, getattr(np, name)(f, i))


def test_a_summed_comparison_stays_off_the_kernel():
  f32 = np.arange(12, dtype=np.float32).reshape(3, 4)
  before = dict(K.counts)
  got = (sp.from_numpy(f32) > 5.0).sum().glom()
  assert int(got) == 6
  assert K.counts["routed_plain"] == before["routed_plain"] + 1
  assert K.counts["plain_runs"] == before["plain_runs"]


@pytest.mark.parametrize("axis", [0, 1, -1, (0, 2), (0, -1)], ids=str)
def test_expand_dims_matches_reference(axis):
  f, _ = _operands()
  want = np.asarray(ref.expand_dims(ref.from_numpy(f), axis).glom())
  got = sp.expand_dims(sp.from_numpy(f), axis).glom()
  assert got.shape == want.shape == np.expand_dims(f, axis).shape
  np.testing.assert_array_equal(got, want)
