"""Port kernel K1 (fused elementwise + sum) on the CPU: its plain torch
version against the reference Pallas kernel in interpret mode, and its op
program against the chain's own torch evaluation.

Tolerances against the reference kernel: rtol 1e-5 with a float32
accumulator (the two sum in different orders), 1e-6 with a float64 one
(the per-element values agree to the last bit for IEEE-rounded ops; exp
may differ by an ulp between XLA's and torch's CPU implementations).  For
bfloat16 input with a float32 accumulator the reference kernel's own sum
is the loose one: on the exp chain at 64x256 it lands 4.4e-5 from the
exact sum of its own per-element values, so that pairing is held at 1e-4,
and the port's result is also held at 1e-5 against the float64 sum of the
same per-element values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spartan_tpu.backend.kernels import fused_reduce as ref_kernels

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def call(name, *deps):
  return FnCallExpr(UFUNCS[name], list(deps))


V, S = LocalInput(0), LocalInput(1)

# name → (port LocalExpr chain or None, reference jnp function, has scalar)
CHAINS = {
    "identity": (None, lambda v: v, False),
    "one_plus_2v": (call("add", LocalConst(1.0),
                         call("multiply", V, LocalConst(2.0))),
                    lambda v: 1.0 + v * 2.0, False),
    "abs_one_plus_2v": (call("absolute", call(
        "add", LocalConst(1.0), call("multiply", V, LocalConst(2.0)))),
                        lambda v: jnp.abs(1.0 + v * 2.0), False),
    "exp_neg_v2": (call("exp", call("multiply", call("negative", V), V)),
                   lambda v: jnp.exp(-v * v), False),
    "runtime_scalar": (call("maximum", call("multiply", V, S),
                            LocalConst(0.0)),
                       lambda v, s: jnp.maximum(v * s, 0.0), True),
}
SHAPES = [(64, 256), (13, 20), (1000,)]
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (None, torch.bfloat16, jnp.bfloat16)}
ACCS = {"acc32": (torch.float32, jnp.float32),
        "acc64": (torch.float64, jnp.float64)}
RTOL = {("f32", "acc32"): 1e-5, ("bf16", "acc32"): 1e-4,
        ("f32", "acc64"): 1e-6, ("bf16", "acc64"): 1e-6}


def _data(shape, seed=7):
  # positive mean: sums do not cancel, so rtol measures the kernel
  return np.random.default_rng(seed).uniform(-1.0, 2.0, shape).astype(
      np.float32)


def _port_input(host, dtype):
  return torch.from_numpy(host).to(dtype)


@pytest.mark.parametrize("acc", sorted(ACCS))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_plain_matches_reference_kernel(chain, shape, dt, acc):
  local_op, jfn, has_scalar = CHAINS[chain]
  _, tdt, jdt = DTYPES[dt]
  tacc, jacc = ACCS[acc]
  host = _data(shape)
  x = _port_input(host, tdt)
  scalars = [torch.tensor(0.7, dtype=torch.float32)] if has_scalar else []
  program = K.plan(local_op, 0, tdt, dict(enumerate(scalars, start=1)))
  assert program is not None
  before = K.counts["plain_runs"]
  got = K.fused_sum(x, program, scalars, tacc)
  assert K.counts["plain_runs"] == before + 1
  assert got.dtype == tacc and got.shape == ()
  jx = jnp.asarray(host).astype(jdt)
  want = ref_kernels.fused_sum(
      jx, jfn, scalars=[jnp.float32(0.7)] if has_scalar else [],
      acc_dtype=jacc, interpret=True)
  np.testing.assert_allclose(float(got), float(want), rtol=RTOL[dt, acc])
  exact = K.evaluate_program(program, x, scalars).sum(dtype=torch.float64)
  np.testing.assert_allclose(float(got), float(exact), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_program_matches_chain_evaluation(chain, dtype):
  """The translated program computes exactly what the LocalExpr chain
  computes with torch ops (bit for bit, every instruction in its dtype)."""
  local_op, _, has_scalar = CHAINS[chain]
  x = _port_input(_data((16, 24), seed=3), dtype)
  scalars = [torch.tensor(0.7, dtype=torch.float32)] if has_scalar else []
  program = K.plan(local_op, 0, dtype, dict(enumerate(scalars, start=1)))
  got = K.evaluate_program(program, x, scalars)
  want = x if local_op is None else local_op.evaluate([x] + scalars)
  assert got.dtype == want.dtype == program.dtype
  torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_program_promotes_like_numpy():
  """A strong float64 scalar (ConstFoldCreations' leaf) lifts the chain to
  float64 from that node on; a weak Python scalar does not."""
  strong = call("add", S, call("multiply", V, LocalConst(2.0)))
  x = _port_input(_data((8, 8)), torch.float32)
  one = torch.tensor(1.0, dtype=torch.float64)
  p = K.plan(strong, 0, torch.float32, {1: one})
  assert p.dtype == torch.float64
  assert [ins[1] for ins in p.instrs if ins[0] >= 3] == [
      K.DTYPE_CODES[torch.float32], K.DTYPE_CODES[torch.float64]]
  weak = K.plan(strong, 0, torch.float32, {1: 1.0})
  assert weak.dtype == torch.float32
  torch.testing.assert_close(K.evaluate_program(p, x, [one]),
                             strong.evaluate([x, one]), rtol=0, atol=0)


def _add_named_but_multiplies(x, y):
  return x * y


_add_named_but_multiplies.__name__ = "add"


@pytest.mark.parametrize("case", ["op_outside_table", "integer_node",
                                  "too_long", "foreign_fn_with_table_name"])
def test_untranslatable_chain_routes_plain_counted(case):
  scalars = {}
  if case == "op_outside_table":
    chain = FnCallExpr(torch.sin, [V])
  elif case == "foreign_fn_with_table_name":
    chain = FnCallExpr(_add_named_but_multiplies, [V, LocalConst(2.0)])
  elif case == "integer_node":
    # an int64 intermediate (strong int scalar + 1) cannot be a register
    chain = call("multiply", V, call("add", S, LocalConst(1)))
    scalars = {1: torch.tensor(3)}
  else:
    chain = V
    for _ in range(K.MAX_INSTR):
      chain = call("add", chain, LocalConst(1.0))
  before = K.counts["routed_plain"]
  assert K.plan(chain, 0, torch.float32, scalars) is None
  assert K.counts["routed_plain"] == before + 1


def test_untranslatable_chain_through_expression_layer():
  """sum(sin(b)) takes the reduction's plain path, counted, and agrees
  with numpy."""
  host = _data((32, 64))
  b = sp.from_numpy(host)
  before = dict(K.counts)
  got = float(sp.map(b, torch.sin).sum().glom())
  assert K.counts["routed_plain"] == before["routed_plain"] + 1
  assert K.counts["plain_runs"] == before["plain_runs"]
  np.testing.assert_allclose(got, np.sin(host).astype(np.float64).sum(),
                             rtol=1e-6)


def test_cuda_only_checks_do_not_fire_on_cpu():
  """A CPU tensor never reaches the launch path (no build, no nvcc)."""
  before = K.counts["launches"]
  x = _port_input(_data((4, 4)), torch.float32)
  program = K.plan(None, 0, torch.float32, {})
  K.fused_sum(x.t(), program, [], torch.float64)  # non-contiguous is fine
  assert K.counts["launches"] == before
