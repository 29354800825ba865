"""``sp.shuffle`` (scatter with a combiner) and ``canonical_reducer``
against the reference on the same seeded data, case for case with
tests/test_shuffle.py, plus the reducers, index forms and dtypes that file
leaves out.  The user's emit function takes jax arrays in the reference
and torch tensors in the port.

Tolerance: float64 throughout; sums of the same values in another order
agree to 1e-12 relative, max/min/set exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.core.array import canonical_reducer as ref_canonical

import spartan_tpu_torch as sp
from spartan_tpu_torch.core.array import canonical_reducer


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _both(arrays, ref_emit, port_emit, **kw):
  """(reference result, port result) of the same shuffle."""
  target = kw.pop("target", None)
  ref_kw, port_kw = dict(kw), dict(kw)
  if target is not None:
    ref_kw["target"] = ref.from_numpy(target)
    port_kw["target"] = sp.from_numpy(target)
  want = ref.shuffle([ref.from_numpy(a) for a in arrays], ref_emit,
                     **ref_kw).glom()
  got = sp.shuffle([sp.from_numpy(a) for a in arrays], port_emit,
                   **port_kw).glom()
  return np.asarray(want), got


def test_scatter_add_histogram(rng):
  vals = rng.integers(0, 10, (100,))
  want, got = _both(
      [vals], lambda x, c: ((x,), jnp.ones_like(x, dtype=jnp.float64)),
      lambda x, c: ((x,), torch.ones_like(x, dtype=torch.float64)),
      target_shape=(10,), reducer=np.add)
  assert got.dtype == want.dtype == np.float64
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, np.bincount(vals, minlength=10))


@pytest.mark.parametrize("reducer, init", [(np.maximum, -np.inf),
                                           (np.minimum, np.inf),
                                           (np.multiply, 1.0), (np.add, 0.5)],
                         ids=["max", "min", "mul", "add"])
def test_scatter_reducers_with_init(rng, reducer, init):
  vals = rng.standard_normal((64,))
  buckets = rng.integers(0, 8, (64,))
  want, got = _both([vals, buckets], lambda v, b, c: ((b,), v),
                    lambda v, b, c: ((b,), v), target_shape=(8,),
                    reducer=reducer, init=init)
  np.testing.assert_allclose(got, want, rtol=1e-12)
  oracle = np.full(8, init)
  reducer.at(oracle, buckets, vals)
  np.testing.assert_allclose(got, oracle, rtol=1e-12)


def test_scatter_centroid_update(rng):
  pts = rng.standard_normal((40, 3))
  labels = rng.integers(0, 4, (40,))
  want, got = _both(
      [pts, labels],
      lambda p, l, c: ((jnp.broadcast_to(l[:, None], p.shape), c[1]), p),
      lambda p, l, c: ((l[:, None].expand(p.shape), c[1]), p),
      target_shape=(4, 3), reducer=np.add)
  np.testing.assert_allclose(got, want, rtol=1e-12)


def test_transpose_via_shuffle_set(rng):
  a = rng.standard_normal((6, 9))
  want, got = _both([a], lambda x, c: ((c[1], c[0]), x),
                    lambda x, c: ((c[1], c[0]), x), target_shape=(9, 6),
                    reducer=None)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, a.T)


def test_scatter_into_reduce_fusion(rng):
  vals = rng.integers(0, 5, (50,))
  total = sp.shuffle(sp.from_numpy(vals),
                     lambda x, c: ((x,), torch.ones_like(x, dtype=torch.float64)),
                     target_shape=(5,), reducer=np.add).sum()
  assert total.glom() == 50.0


def test_shuffle_into_existing_target(rng):
  base = rng.standard_normal((5, 3))
  vals = rng.standard_normal((20, 3))
  buckets = rng.integers(0, 5, 20)
  sb = sp.from_numpy(base)
  got = sp.shuffle([sp.from_numpy(vals), sp.from_numpy(buckets)],
                   lambda p, l, c: ((l[:, None].expand(p.shape), c[1]), p),
                   reducer=np.add, target=sb).glom()
  want = ref.shuffle(
      [ref.from_numpy(vals), ref.from_numpy(buckets)],
      lambda p, l, c: ((jnp.broadcast_to(l[:, None], p.shape), c[1]), p),
      reducer=np.add, target=ref.from_numpy(base)).glom()
  np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
  np.testing.assert_array_equal(sb.glom(), base)  # functional: base untouched


def test_partial_and_negative_indices_and_out_dtype(rng):
  """One index array into a 2-D target updates whole rows; negative
  indices count from the end; ``out_dtype`` sets the fresh target's
  dtype."""
  vals = rng.standard_normal((30, 4))
  rows = rng.integers(-6, 6, (30,))
  want, got = _both([vals, rows], lambda v, r, c: ((r,), v),
                    lambda v, r, c: ((r,), v), target_shape=(6, 4),
                    reducer=np.add, out_dtype=np.float32)
  assert got.dtype == np.asarray(want).dtype == np.float32
  np.testing.assert_allclose(got, want, rtol=1e-5)
  want, got = _both([vals, rows], lambda v, r, c: ((r,), v),
                    lambda v, r, c: ((r,), v), target_shape=(6, 4),
                    reducer=np.maximum, init=-np.inf)
  np.testing.assert_array_equal(got, want)


def test_shuffle_requires_shape_or_target():
  with pytest.raises(ValueError, match="target_shape or target"):
    sp.shuffle(sp.ones((4,)), lambda x, c: ((c[0],), x))


@pytest.mark.parametrize("reducer", [None, "set", np.add, "add", "sum",
                                     np.multiply, "mul", np.maximum, "max",
                                     np.minimum, "min"],
                         ids=lambda r: getattr(r, "__name__", str(r)))
def test_canonical_reducer_matches_reference(reducer):
  assert canonical_reducer(reducer) == ref_canonical(reducer)


@pytest.mark.parametrize("reducer, op", [(torch.add, "add"),
                                         (torch.mul, "mul"),
                                         (torch.maximum, "max"),
                                         (torch.minimum, "min")],
                         ids=["add", "mul", "maximum", "minimum"])
def test_canonical_reducer_takes_torch_functions(reducer, op):
  assert canonical_reducer(reducer) == op


def test_canonical_reducer_refuses_others():
  with pytest.raises(ValueError, match="unsupported reducer"):
    canonical_reducer(np.subtract)
  with pytest.raises(ValueError, match="unsupported reducer"):
    canonical_reducer("median")
