"""K2's plain version (``matmul_plain``) against the reference's Pallas
``matmul.matmul(..., interpret=True)``, and the epilogue's translation into
K1's op program (``matmul.plan_epilogue``) checked by evaluating the
program with torch.

Tolerance: the two sides sum the same K exact products in float32 in
another order (the reference per K block, the port in one torch matmul),
so they differ by d <= 2·K·2^-24·(|x| @ |y|); a bfloat16 output rounds each
side once more, 2u·(|ref| + d) on top (u = 2^-8).  The translated programs
run the epilogue's own torch ops in its order, so they agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_tpu.backend.kernels import matmul as ref_matmul

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.backend.kernels import matmul as K2


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _relu(acc):
  return torch.clamp_min(acc, 0.0)


def _inputs(m, k, n, seed):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal((m, k)).astype(np.float32),
          rng.standard_normal((k, n)).astype(np.float32))


def _close(got, want, x, y, unit):
  got = got.float().numpy().astype(np.float64)
  want = np.asarray(want, np.float64)
  d = 2.0 * x.shape[1] * 2.0 ** -24 * (np.abs(x.astype(np.float64))
                                      @ np.abs(y.astype(np.float64)))
  tol = d + 2.0 * unit * (np.abs(want) + d)
  assert got.shape == want.shape
  assert bool((np.abs(got - want) <= tol).all())


# (m, k, n, bm, bn, bk): the reference test's two shapes and a shape off
# the (8, 128) grid, where the reference takes full-dimension blocks
SHAPES = [(64, 256, 128, 32, 128, 128), (32, 128, 128, 32, 128, 128),
          (17, 40, 72, 512, 512, 512)]


@pytest.mark.parametrize("relu", [False, True], ids=["none", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matmul_plain_matches_reference_kernel(shape, dtype, relu):
  m, k, n, bm, bn, bk = shape
  a, b = _inputs(m, k, n, m + k + n)
  jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
  want = ref_matmul.matmul(
      ja, jb, bm=bm, bn=bn, bk=bk,
      epilogue=(lambda acc: jnp.maximum(acc, 0.0)) if relu else None,
      interpret=True)
  assert want.dtype == jdt
  ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
  before = dict(K2.counts)
  got = K2.matmul(ta, tb, bm=bm, bn=bn, bk=bk,
                  epilogue=_relu if relu else None)
  assert K2.counts == dict(before, plain_runs=before["plain_runs"] + 1)
  assert got.dtype == tdt
  _close(got, np.asarray(want.astype(jnp.float32)),
         ta.float().numpy(), tb.float().numpy(),
         0.0 if dtype == "float32" else 2.0 ** -8)


EPILOGUES = {
    "clamp_min": lambda a: torch.clamp_min(a, 0.0),
    "F.relu": lambda a: torch.nn.functional.relu(a),
    "torch.relu": lambda a: torch.relu(a),
    "method relu": lambda a: a.relu(),
    "affine": lambda a: 1.0 - 2 * a,
    "bias then scale": lambda a: (a + 0.5) / 3.0,
    "abs plus": lambda a: abs(a) + 3,
    "gaussian": lambda a: torch.exp(-a * a),
    "leaky": lambda a: torch.maximum(a, a * 0.1),
    "clamps": lambda a: a.clamp_min(-1.0).clamp_max(1.0),
    "sqrt log": lambda a: torch.log(torch.sqrt(torch.square(a) + 1.0)),
    "identity": lambda a: a,
}


@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_epilogue_translates_into_the_op_program(name):
  epilogue = EPILOGUES[name]
  program = K2.plan_epilogue(epilogue)
  assert program is not None
  assert program.dtype == torch.float32 and not program.dev_scalars
  acc = torch.from_numpy(
      np.random.default_rng(3).standard_normal((9, 13)).astype(np.float32))
  got = K.evaluate_program(program, acc, [])
  assert got.dtype == torch.float32
  assert torch.equal(got, epilogue(acc))


OUTSIDE = {
    "tanh": torch.tanh,
    "power": lambda a: a ** 2,
    "to float64": lambda a: a.double(),
    "clamp with keywords": lambda a: torch.clamp(a, min=0.0),
    "tensor operand": lambda a: a + torch.ones(13),
    "data-dependent branch": lambda a: a if a.sum() > 0 else -a,
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_epilogue_outside_the_table_is_not_translated(name):
  assert K2.plan_epilogue(OUTSIDE[name]) is None


SCALE = 2.0


def test_epilogue_plan_follows_a_changed_global():
  """fx bakes a global number into the program as an immediate, so the plan
  of one function must follow the global's current value."""
  global SCALE
  epilogue = lambda a: a * SCALE  # noqa: E731
  acc = torch.arange(-3.0, 4.0)
  try:
    for value in (2.0, -0.5, 3):
      SCALE = value
      program = K2.plan_epilogue(epilogue)
      assert program is not None
      assert torch.equal(K.evaluate_program(program, acc, []), acc * value)
  finally:
    SCALE = 2.0


def test_matmul_wrapper_checks_shapes_and_runs_plain_on_cpu():
  a, b = _inputs(5, 6, 7, 1)
  ta, tb = torch.from_numpy(a), torch.from_numpy(b)
  with pytest.raises(ValueError, match="x \\(M, K\\) and y \\(K, N\\)"):
    K2.matmul(ta, tb.t())
  got = K2.matmul(ta.double(), tb.double(), epilogue=torch.tanh)
  assert got.dtype == torch.float64
  want = torch.tanh(ta @ tb).double()
  torch.testing.assert_close(got, want, rtol=0, atol=0)
