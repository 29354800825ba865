"""``while_loop``, ``scan_iters`` and ``cond`` (and the step cache they share
with ``make_fori``) in both packages on the same seeded inputs: the
counterparts of the reference's ``tests/test_loop.py``, plus
``examples/cg.py``.

Tolerances: exact where the loop only adds, doubles or halves
(``while_loop`` counts, ``scan_iters`` doublings, ``cond`` branches);
float64 CG at 1e-10 of max|x| against the reference (the same recurrence,
inner products summed in another order, over at most a few dozen
iterations of a system whose condition number is below 10); float32 CG
at 1e-4 of max|x| (float32's 6e-8 a step, times the iterations and the
condition number); ``norm`` per step at rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.examples import cg as ref_cg

import spartan_tpu_torch as sp
from spartan_tpu_torch.examples import cg
from spartan_tpu_torch.expr import loop as loop_mod

DTYPES = [np.float64, np.float32]
CG_TOL = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _both(fn):
  """``fn(pkg)`` run on the port and on the reference, as numpy."""
  return (np.asarray(sp.lazify(fn(sp)).glom()),
          np.asarray(ref.lazify(fn(ref)).glom()))


def test_while_loop_counts():
  got, want = _both(lambda pkg: pkg.while_loop(
      lambda c: pkg.sum(c) < 10.0, lambda c: c + 1.0, pkg.zeros((2,))))
  np.testing.assert_array_equal(got, [5.0, 5.0])
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_while_loop_cg_to_tolerance(dtype):
  """CG iterating to tolerance (the reference test's system)."""
  A_np, b_np, x_true = cg.make_spd(32, seed=6)
  A_np, b_np = A_np.astype(dtype), b_np.astype(dtype)
  tol = 1e-10 if dtype == np.float64 else 1e-3

  def solve(pkg):
    A, b = pkg.from_numpy(A_np), pkg.from_numpy(b_np)

    def cond(x, r, p, rs):
      return pkg.sqrt(rs) > tol

    def body(x, r, p, rs):
      Ap = pkg.dot(A, p)
      alpha = (rs / pkg.dot(p, Ap)).astype(dtype)
      x2 = x + alpha * p
      r2 = r - alpha * Ap.astype(dtype)
      rs2 = pkg.dot(r2, r2).astype(dtype)
      p2 = r2 + (rs2 / rs) * p
      return x2, r2, p2, rs2

    return pkg.while_loop(
        cond, body,
        (pkg.zeros((32,), dtype=dtype), pkg.from_numpy(b_np),
         pkg.from_numpy(b_np), pkg.from_numpy(np.asarray(b_np @ b_np))),
        max_iters=200)[0]

  if dtype == np.float32:
    ref.FLAGS.float64_reductions = False  # the reference's float32 dots
  try:
    got, want = _both(solve)
  finally:
    ref.FLAGS.float64_reductions = True
  assert got.dtype == dtype
  scale = np.abs(x_true).max()
  np.testing.assert_allclose(got, want, rtol=0, atol=CG_TOL[dtype] * scale)
  np.testing.assert_allclose(got, x_true, rtol=0,
                             atol=1e-7 if dtype == np.float64 else 1e-4)


def test_while_loop_max_iters():
  got, want = _both(lambda pkg: pkg.while_loop(
      lambda c: pkg.sum(c) < 1e9, lambda c: c + 1.0, pkg.zeros(()),
      max_iters=7))
  assert float(got) == 7.0 == float(want)


def test_while_loop_false_condition_runs_no_iteration():
  """``lax.while_loop``'s order: the condition is tested before the first
  body, so a false ``cond(init)`` returns ``init`` and the body's step
  never runs."""
  calls = []

  def count(t):
    if t.device.type != "meta":  # a carry, not shape inference
      calls.append(1)
    return t + 1.0

  def body(c):
    return sp.map([c], count)

  v = np.arange(3.0)
  out = sp.while_loop(lambda c: sp.sum(c) > 100.0, body, sp.from_numpy(v))
  np.testing.assert_array_equal(out.glom(), v)
  assert calls == []
  want = ref.while_loop(lambda c: ref.sum(c) > 100.0, lambda c: c + 1.0,
                        ref.from_numpy(v))
  np.testing.assert_array_equal(np.asarray(want.glom()), v)


def test_while_loop_keeps_the_inits_tiling():
  v = sp.lazify(sp.from_numpy(np.ones(4))).evaluate()
  out = sp.while_loop(lambda c: sp.sum(c) < 10.0, lambda c: c * 2.0, v)
  assert out.tiling is v.tiling


def test_while_cond_must_be_scalar():
  with pytest.raises(ValueError, match="scalar"):
    sp.while_loop(lambda c: c > 0, lambda c: c - 1.0, sp.ones((4,)))


@pytest.mark.parametrize("which", ["shape", "dtype"])
def test_while_loop_carry_must_keep_shape_and_dtype(which):
  def body(c, k):
    if which == "shape":
      return sp.sum(c), k + 1
    return c, (k + 1).astype(np.float64)

  with pytest.raises(ValueError, match="carry changed"):
    sp.while_loop(lambda c, k: k < 3, body,
                  (sp.ones((4,)), np.int32(0)))


def test_while_loop_counter_keeps_int32():
  """A weak Python int added to an int32 counter stays int32 (NumPy 2 and
  JAX agree), so the reference's ``(k + 1).astype(np.int32)`` idiom and a
  bare ``k + 1`` both keep the carry's dtype."""
  x, k = sp.while_loop(lambda x, k: k < 5, lambda x, k: (x * 2.0, k + 1),
                       (sp.ones(()), np.int32(0)))
  assert k.dtype == torch.int32 and int(k.glom()) == 5
  assert float(x.glom()) == 32.0


def test_scan_iters_collects():
  (f, c), (rf, rc) = [(np.asarray(a.glom()), np.asarray(b.glom()))
                      for a, b in (pkg.scan_iters(5, lambda c: c * 2.0,
                                                  pkg.ones(()))
                                   for pkg in (sp, ref))]
  assert float(f) == 32.0 == float(rf)
  np.testing.assert_array_equal(c, [2, 4, 8, 16, 32])
  np.testing.assert_array_equal(c, rc)


def test_scan_iters_custom_collect():
  a_np = np.random.default_rng(42).standard_normal(8)

  def run(pkg):
    a = pkg.from_numpy(a_np)
    return pkg.scan_iters(4, lambda c: c + a, pkg.zeros((8,)),
                          collect=lambda c: pkg.norm(c + a))[1]

  got, want = _both(run)
  np.testing.assert_allclose(
      got, [np.linalg.norm(k * a_np) for k in range(1, 5)], rtol=1e-12)
  np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("form", [tuple, list])
def test_scan_iters_tuple_collect_stacks_a_tuple(form):
  """The stacked output is a tuple exactly when ``collect`` returns a tuple
  or list; one output per collected value, each ``(n, ...)``."""
  final, (xs, ks) = sp.scan_iters(
      3, lambda x, k: (x + 1.0, k + 1), (sp.zeros((2,)), np.int32(0)),
      collect=lambda x, k: form([x * 10.0, k]))
  np.testing.assert_array_equal(xs.glom(), [[0, 0], [10, 10], [20, 20]])
  np.testing.assert_array_equal(ks.glom(), [0, 1, 2])
  assert ks.dtype == torch.int32
  np.testing.assert_array_equal(final[0].glom(), [3, 3])
  _, one = sp.scan_iters(3, lambda x: x + 1.0, sp.zeros((2,)),
                         collect=lambda x: x * 10.0)
  assert isinstance(one, sp.SpartanArray) and one.shape == (3, 2)


def test_scan_iters_final_carry_equals_make_fori():
  rng = np.random.default_rng(3)
  M = sp.from_numpy(rng.random((16, 16)) / 16)
  r0 = sp.from_numpy(rng.random(16))

  def step(r):
    return sp.dot(M, r) * 0.85 + 0.15 / 16

  final, deltas = sp.scan_iters(
      12, step, r0, collect=lambda r: sp.sum(sp.abs(step(r) - r)))
  np.testing.assert_array_equal(final.glom(), sp.make_fori(step, r0)(12).glom())
  assert deltas.shape == (12,)
  want = np.asarray(ref.scan_iters(
      12, lambda r: ref.dot(ref.from_numpy(M.glom()), r) * 0.85 + 0.15 / 16,
      ref.from_numpy(r0.glom()))[0].glom())
  np.testing.assert_allclose(final.glom(), want, rtol=1e-12)


@pytest.mark.parametrize("hi", [True, False])
def test_cond_branches(hi):
  a_np = np.random.default_rng(42).standard_normal(8)
  limit = -1e9 if hi else 1e9
  got, want = _both(lambda pkg: pkg.cond(
      pkg.sum(pkg.from_numpy(a_np)) > limit, lambda x: x * 2.0,
      lambda x: x * 0.5, pkg.from_numpy(a_np)))
  np.testing.assert_array_equal(got, a_np * (2.0 if hi else 0.5))
  np.testing.assert_array_equal(got, want)


def test_cond_tuple_operands():
  s, d = sp.cond(sp.sum(sp.ones((4,))) > 2.0,
                 lambda x, y: (x + y, x - y),
                 lambda x, y: (x * y, y / x),
                 (sp.ones((4,)), sp.full((4,), 3.0)))
  np.testing.assert_array_equal(s.glom(), 4.0)
  np.testing.assert_array_equal(d.glom(), -2.0)
  s, d = sp.cond(sp.sum(sp.ones((4,))) > 20.0,
                 lambda x, y: (x + y, x - y),
                 lambda x, y: (x * y, y / x),
                 (sp.ones((4,)), sp.full((4,), 3.0)))
  np.testing.assert_array_equal(s.glom(), 3.0)
  np.testing.assert_array_equal(d.glom(), 3.0)


def test_cond_shape_mismatch_rejected():
  a = sp.ones((4,))
  with pytest.raises(ValueError, match="branch shapes"):
    sp.cond(sp.sum(a) > 0, lambda x: x, lambda x: sp.sum(x), a)


def test_cond_output_count_mismatch_rejected():
  a = sp.ones((4,))
  with pytest.raises(ValueError, match="same number"):
    sp.cond(sp.sum(a) > 0, lambda x: (x, x), lambda x: x, a)


def test_cond_pred_must_be_scalar():
  a = sp.ones((4,))
  with pytest.raises(ValueError, match="scalar"):
    sp.cond(a > 0, lambda x: x, lambda x: x * 2.0, a)


def test_runner_cache_reuses_and_rebinds_values():
  """Structurally identical loops share ONE cached step; constant leaf
  values rebind positionally."""
  loop_mod.clear_runner_cache()
  rng = np.random.default_rng(42)
  a = rng.standard_normal((8, 8))
  b = rng.standard_normal((8, 8))

  def make(mat):
    M = sp.from_numpy(mat)
    return sp.fori_loop(3, lambda w: sp.dot(M, w), sp.from_numpy(np.eye(8)))

  r1 = make(a).glom()
  n_cached = len(loop_mod._runner_cache)
  r2 = make(b).glom()
  assert len(loop_mod._runner_cache) == n_cached  # same step reused
  np.testing.assert_allclose(r1, np.linalg.matrix_power(a, 3), atol=1e-9)
  np.testing.assert_allclose(r2, np.linalg.matrix_power(b, 3), atol=1e-9)


def test_runner_cache_keys_on_max_iters_and_structure():
  loop_mod.clear_runner_cache()
  v = sp.from_numpy(np.ones(4))

  def go(mi):
    return sp.while_loop(lambda x, k: sp.sum(x) < 1e6,
                         lambda x, k: (x * 2.0, (k + 1).astype(np.int32)),
                         (v, np.int32(0)), max_iters=mi)

  x1, k1 = go(3)
  x2, k2 = go(5)
  assert int(k1.glom()) == 3
  assert int(k2.glom()) == 5  # distinct max_iters: no alias
  assert len(loop_mod._runner_cache) == 2
  go(5)
  assert len(loop_mod._runner_cache) == 2


def test_runner_cache_bypasses_cached_interiors():
  """An interior expr that gains an evaluation cache between two calls
  changes the optimized DAG invisibly to the raw signature: such bodies
  are not cached."""
  loop_mod.clear_runner_cache()
  rng = np.random.default_rng(42)
  A = sp.from_numpy(rng.standard_normal((6, 6)))
  B = sp.from_numpy(rng.standard_normal((6, 6)))
  e = sp.dot(A, B)          # interior node shared into both bodies
  w0 = sp.from_numpy(np.ones(6))
  r1 = sp.fori_loop(2, lambda w: w + sp.dot(e, w), w0).glom()
  assert len(loop_mod._runner_cache) == 1
  e.evaluate()              # now e carries an interior cache
  r2 = sp.fori_loop(2, lambda w: w + sp.dot(e, w), w0).glom()
  assert len(loop_mod._runner_cache) == 1  # bypassed, not added
  np.testing.assert_allclose(r1, r2, atol=1e-9)


def test_runner_cache_cond():
  """Repeated structurally identical conds share ONE cached pair of steps;
  the predicate's value still picks the branch through the shared key."""
  loop_mod.clear_runner_cache()
  rng = np.random.default_rng(42)
  a = rng.standard_normal((8,))

  def go(vec, flip):
    v = sp.from_numpy(vec)
    return sp.cond(sp.sum(v) > (-1e9 if flip else 1e9),
                   lambda x: x * 2.0, lambda x: x - 1.0, v)

  r1 = go(a, True).glom()
  n_cached = len(loop_mod._runner_cache)
  assert n_cached == 1
  assert next(iter(loop_mod._runner_cache))[0] == "cond"
  b = rng.standard_normal((8,))
  r2 = go(b, True).glom()
  assert len(loop_mod._runner_cache) == n_cached  # reused, no new entry
  np.testing.assert_array_equal(r1, a * 2.0)
  np.testing.assert_array_equal(r2, b * 2.0)
  r3 = go(b, False).glom()
  np.testing.assert_array_equal(r3, b - 1.0)
  assert len(loop_mod._runner_cache) == n_cached
  s1 = sp.cond(sp.Val(np.float64(1.0)) > 0,
               lambda x, y: (x + y, x - y),
               lambda x, y: (x * y, x / y),
               (sp.Val(np.float64(1.0)), sp.Val(np.float64(3.0))))
  assert isinstance(s1, tuple) and len(s1) == 2


def test_while_and_fori_bodies_of_one_signature_do_not_share_an_entry():
  """Each kind of loop keys its steps by its own tag: a ``fori`` step is
  never handed to a ``while`` loop, or back."""
  loop_mod.clear_runner_cache()
  v = sp.from_numpy(np.ones(3))

  def body(x):
    return x * 3.0

  fori = sp.fori_loop(2, body, v).glom()
  whiled = sp.while_loop(lambda x: sp.sum(x) < 20.0, body, v).glom()
  np.testing.assert_array_equal(fori, [9, 9, 9])
  np.testing.assert_array_equal(whiled, [9, 9, 9])
  assert sorted(k[0] for k in loop_mod._runner_cache) == ["fori", "while"]
  sym = loop_mod.SymbolicVal(sp.lazify(v).aval())
  roots = [sp.lazify(body(sym))]
  init = [v.evaluate()]
  assert (loop_mod._runner_key("fori", roots, init)
          != loop_mod._runner_key("while", roots, init))


def test_scan_keys_on_its_length():
  loop_mod.clear_runner_cache()
  for n in (2, 3, 3):
    sp.scan_iters(n, lambda c: c * 2.0, sp.ones(()))
  assert sorted(k[3] for k in loop_mod._runner_cache) == [(2, 1), (3, 1)]


@pytest.mark.parametrize("n", [32, 96])
def test_cg_example_solve_matches_reference(n):
  A, b, x_true = cg.make_spd(n, seed=1)
  np.testing.assert_array_equal(A, ref_cg.make_spd(n, seed=1)[0])
  got = cg.solve(sp.from_numpy(A), sp.from_numpy(b), iterations=60).glom()
  want = np.asarray(ref_cg.solve(ref.from_numpy(A), ref.from_numpy(b),
                                 iterations=60).glom())
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
  np.testing.assert_allclose(got, x_true, atol=1e-8)


@pytest.mark.parametrize("n", [32, 96])
def test_cg_example_solve_fused_matches_reference(n):
  A, b, x_true = cg.make_spd(n, seed=2)
  got = cg.solve_fused(sp.from_numpy(A), sp.from_numpy(b)).glom()
  want = np.asarray(ref_cg.solve_fused(ref.from_numpy(A),
                                       ref.from_numpy(b)).glom())
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
  np.testing.assert_allclose(got, x_true, atol=1e-8)


def test_cg_example_run():
  x, x_true = cg.run(64, 40)
  rx, rx_true = ref_cg.run(64, 40)
  np.testing.assert_array_equal(x_true, rx_true)
  np.testing.assert_allclose(x.glom(), np.asarray(rx.glom()), atol=1e-10)
  np.testing.assert_allclose(x.glom(), x_true, atol=1e-8)
