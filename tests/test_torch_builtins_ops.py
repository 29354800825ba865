"""K1's op program and K2's epilogue taking the trig, hyperbolic, rounding
and log/exp ufuncs (the 31 new opcodes, all "rare": only the kernel
variants of ``csrc/fused_reduce_rare1.cu`` and ``fused_reduce_rare.cu``
and K2's epilogue carry them).

* The opcode table: the packed word's Python mirror round-trips every
  opcode (``tests/test_torch_op_program.py`` for the fields), the C enum
  names each code, ``is_binary``'s two compares agree with ``_ARITY``,
  ``RARE_OPS`` with ``is_rare_op``'s two ranges.
* Translation: each op's chain becomes its opcode; ``fix`` is trunc's
  op; ``rad2deg``/``deg2rad`` of float32 and float64 a multiply by NumPy's
  constant, refused (counted) at 16 bits; a new op beside a float64
  instruction is refused and counted, as the reference's K1 takes only
  float32 and 16-bit mains.
* ``allocate`` never overwrites a live value on random trees of the new
  ops, and gives the SSA program's bits.
* K1's plain version (``fused_sum`` on the CPU, through ``plan``) against
  the reference's ``fused_sum(..., interpret=True)`` with the same ``f``,
  at float32 and bfloat16 mains.  Tolerance, against the sum of
  ``|values|`` (a sum of sines cancels): 1e-6 for a float32 main with a
  float64 sum (XLA's and torch's CPU transcendentals differ by about an
  ulp an element, 6e-8 of it), 2e-5 with a float32 sum (the two sums add in
  different orders), and one bfloat16 ulp, 2^-8, for a bfloat16 main (an
  ulp of float32 apart before the rounding can land a value on either
  side of a bfloat16 boundary).  The exact ops (rounding, copysign,
  fmax/fmin) at float64 sums are held to 1e-12.
* K2: the epilogue translation of ``tanh``, ``sin`` and ``floor`` against
  the reference's ``matmul(..., epilogue=f, interpret=True)``.
"""

import pathlib

import numpy as np
import pytest
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.backend.kernels import matmul as K2
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def call(name, *deps):
  return FnCallExpr(UFUNCS[name], list(deps))


V = LocalInput(0)
HEADER = (pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
          / "op_program.cuh").read_text()

# the 31 new ops: name → (the chain over V, the reference's f, the domain)
NEW_OPS = {
    "sin": (lambda jnp: jnp.sin, "any"), "cos": (lambda jnp: jnp.cos, "any"),
    "tan": (lambda jnp: jnp.tan, "any"),
    "arcsin": (lambda jnp: jnp.arcsin, "unit"),
    "arccos": (lambda jnp: jnp.arccos, "unit"),
    "arctan": (lambda jnp: jnp.arctan, "any"),
    "sinh": (lambda jnp: jnp.sinh, "any"),
    "cosh": (lambda jnp: jnp.cosh, "any"),
    "tanh": (lambda jnp: jnp.tanh, "any"),
    "arcsinh": (lambda jnp: jnp.arcsinh, "any"),
    "arccosh": (lambda jnp: jnp.arccosh, "ge1"),
    "arctanh": (lambda jnp: jnp.arctanh, "unit"),
    "floor": (lambda jnp: jnp.floor, "any"),
    "ceil": (lambda jnp: jnp.ceil, "any"),
    "trunc": (lambda jnp: jnp.trunc, "any"),
    "rint": (lambda jnp: jnp.rint, "any"),
    "exp2": (lambda jnp: jnp.exp2, "any"),
    "expm1": (lambda jnp: jnp.expm1, "any"),
    "log2": (lambda jnp: jnp.log2, "pos"),
    "log10": (lambda jnp: jnp.log10, "pos"),
    "log1p": (lambda jnp: jnp.log1p, "pos"),
    "cbrt": (lambda jnp: jnp.cbrt, "any"),
    "erf": (lambda jnp: __import__("jax").scipy.special.erf, "any"),
    "erfc": (lambda jnp: __import__("jax").scipy.special.erfc, "any"),
    "arctan2": (lambda jnp: lambda v: jnp.arctan2(v, 0.5), "any"),
    "hypot": (lambda jnp: lambda v: jnp.hypot(v, 2.0), "any"),
    "copysign": (lambda jnp: lambda v: jnp.copysign(v, -0.5), "any"),
    "fmax": (lambda jnp: lambda v: jnp.fmax(v, 0.5), "any"),
    "fmin": (lambda jnp: lambda v: jnp.fmin(v, 0.5), "any"),
    "logaddexp": (lambda jnp: lambda v: jnp.logaddexp(v, 0.5), "any"),
    "logaddexp2": (lambda jnp: lambda v: jnp.logaddexp2(v, 0.5), "any"),
}
CONSTS = {"arctan2": 0.5, "hypot": 2.0, "copysign": -0.5, "fmax": 0.5,
          "fmin": 0.5, "logaddexp": 0.5, "logaddexp2": 0.5}
EXACT_OPS = {"floor", "ceil", "trunc", "rint", "copysign", "fmax", "fmin"}
C_NAMES = {"sin": "SIN", "cos": "COS", "tan": "TAN", "arcsin": "ASIN",
           "arccos": "ACOS", "arctan": "ATAN", "sinh": "SINH",
           "cosh": "COSH", "tanh": "TANH", "arcsinh": "ASINH",
           "arccosh": "ACOSH", "arctanh": "ATANH", "floor": "FLOOR",
           "ceil": "CEIL", "trunc": "TRUNC", "rint": "RINT", "exp2": "EXP2",
           "expm1": "EXPM1", "log2": "LOG2", "log10": "LOG10",
           "log1p": "LOG1P", "cbrt": "CBRT", "erf": "ERF", "erfc": "ERFC",
           "arctan2": "ATAN2", "hypot": "HYPOT", "copysign": "COPYSIGN",
           "fmax": "FMAX", "fmin": "FMIN", "logaddexp": "LOGADDEXP",
           "logaddexp2": "LOGADDEXP2"}


def _chain(name):
  if name in CONSTS:
    return call(name, V, LocalConst(CONSTS[name]))
  return call(name, V)


def _host(domain, shape=(64, 256), seed=7):
  lo, hi = {"any": (-3.0, 3.0), "unit": (-0.95, 0.95), "pos": (0.05, 30.0),
            "ge1": (1.0, 30.0)}[domain]
  out = np.random.default_rng(seed).uniform(lo, hi, shape)
  if domain == "any":
    out.flat[::7] = np.round(out.flat[::7] * 2) / 2  # halves: rint's ties
  return out.astype(np.float32)


def test_the_table_has_31_new_rare_ops_and_the_c_enum_names_them():
  assert len(NEW_OPS) == 31 and set(NEW_OPS) <= set(K.OPS)
  assert max(K.OPS.values()) == 48 < 1 << K.OP_BITS
  for name, c in C_NAMES.items():
    assert f"OP_{c} = {K.OPS[name]}," in HEADER
    assert K.OPS[name] in K.RARE_OPS
  assert "OP_LAST = OP_LOGADDEXP2," in HEADER
  for name in ("add", "negative", "exp", "log", "maximum", "minimum"):
    assert K.OPS[name] not in K.RARE_OPS


@pytest.mark.parametrize("code", sorted(K.OPS.values()))
def test_binary_and_rare_mirror_the_c_ranges(code):
  """``sp_prog::is_binary`` is ``op <= OP_DIV || op >= OP_MAX`` and
  ``is_rare_op`` ``OP_SIN .. OP_ERFC`` or ``OP_FLOORDIV`` on."""
  assert "return op <= OP_DIV || op >= OP_MAX;" in HEADER
  assert "(op >= OP_SIN && op <= OP_ERFC) || (op >= OP_FLOORDIV" in HEADER
  binary = code <= K.OPS["true_divide"] or code >= K.OPS["maximum"]
  assert K._BINARY_OPS[code] == binary
  name = next(n for n, c in K.OPS.items() if c == code)
  assert (K._ARITY[name] == 2) == binary
  rare = (K.OPS["sin"] <= code <= K.OPS["erfc"]
          or code >= K.OPS["floor_divide"])
  assert (code in K.RARE_OPS) == rare
  for dt in K.DTYPE_CODES.values():
    word = K.pack_instruction(code, dt, 5, -3, 7 if binary else 0)
    assert K.unpack_instruction(word) == (code, dt, 5, -3,
                                          7 if binary else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("name", sorted(NEW_OPS))
def test_each_new_op_translates_to_its_opcode(name, dtype):
  chain = _chain(name)
  before = K.counts["routed_plain"]
  program = K.plan(chain, 0, dtype, {})
  if dtype == torch.float64:  # a rare op in double registers: refused
    assert program is None
    assert K.counts["routed_plain"] == before + 1
    return
  assert program is not None and K.has_rare(program)
  assert [op for op, *_ in program.instrs] == [K.LOADX, K.OPS[name]]
  x = torch.from_numpy(_host(NEW_OPS[name][1], (5, 9))).to(dtype)
  want = chain.evaluate([x])
  torch.testing.assert_close(K.evaluate_program(program, x, []), want,
                             rtol=0, atol=0, equal_nan=True)


def test_each_program_picks_its_variant_set():
  """Programs without a rare op run in fused_reduce.cu's variants; with
  one, in fused_reduce_rare1.cu's when they hold one register, else in
  fused_reduce_rare.cu's."""
  def kind(chain):
    return K.variant_set(K.plan(chain, 0, torch.float32, {}))
  assert kind(call("absolute", call("multiply", V, LocalConst(2.0)))) == (
      "common")
  assert kind(call("sin", call("multiply", V, LocalConst(3.0)))) == "rare1"
  assert kind(call("remainder", V, LocalConst(0.7))) == "rare1"
  assert kind(call("add", call("sin", V), call("cos", V))) == "rare"
  assert set(K.SOURCES) == {"common", "rare1", "rare"}
  csrc = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
  for source, entry in K.SOURCES.values():
    assert f"int {entry}(" in (csrc / f"{source}.cu").read_text()


def test_fix_takes_truncs_op():
  program = K.plan(call("fix", call("multiply", V, LocalConst(3.0))), 0,
                   torch.float32, {})
  assert [op for op, *_ in program.instrs] == [K.LOADX, K.OPS["multiply"],
                                              K.OPS["trunc"]]


@pytest.mark.parametrize("name", ["rad2deg", "degrees", "deg2rad", "radians"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=str)
def test_degrees_and_radians_are_a_multiply_with_numpys_bits(name, dtype):
  chain = call(name, V)
  before = K.counts["routed_plain"]
  program = K.plan(chain, 0, dtype, {})
  if dtype == torch.bfloat16:  # float32 then one rounding: no instruction
    assert program is None and K.counts["routed_plain"] == before + 1
    return
  assert [op for op, *_ in program.instrs] == [K.LOADX, K.OPS["multiply"]]
  host = _host("any", (9, 13)).astype(
      np.float64 if dtype == torch.float64 else np.float32)
  x = torch.from_numpy(host)
  got = K.evaluate_program(program, x, [])
  want = getattr(np, name)(host)
  np.testing.assert_array_equal(got.numpy(), want)
  # the kernel's immediate is rounded to the register type once
  c = program.immediates([])[0]
  if dtype == torch.float32:
    np.testing.assert_array_equal((x * np.float32(c)).numpy(), want)


UNARY_NEW = [n for n in NEW_OPS if n not in CONSTS]
BINARY_NEW = sorted(CONSTS)


def _random_tree(rng, budget):
  if budget <= 1 or rng.random() < 0.2:
    return V if rng.random() < 0.7 else LocalConst(
        float(np.round(rng.uniform(0.1, 2.0), 3)))
  pick = rng.random()
  if pick < 0.4:
    return call(str(rng.choice(UNARY_NEW)), _random_tree(rng, budget - 1))
  name = str(rng.choice(BINARY_NEW + ["add", "multiply", "maximum"]))
  left = int(rng.integers(1, budget - 1)) if budget > 2 else 1
  return call(name, _random_tree(rng, left),
              _random_tree(rng, budget - 1 - left))


def _check_no_clobber(ssa, alloc):
  holds = {}
  for (op, dt, dst, a, b), (aop, adt, adst, aa, ab) in zip(ssa.instrs,
                                                           alloc.instrs):
    assert (op, dt) == (aop, adt)
    if op >= 3:
      pairs = [(a, aa)] + ([(b, ab)] if K._BINARY_OPS[op] else [])
      for want, reg in pairs:
        assert reg == want if want < 0 else holds[reg] == want
    holds[adst] = dst
  assert holds[alloc.out] == ssa.out


@pytest.mark.parametrize("seed", range(6))
def test_allocation_of_random_trees_of_new_ops(seed):
  rng = np.random.default_rng(100 + seed)
  x = torch.from_numpy(_host("unit", (6, 10), seed))
  fitted = 0
  for _ in range(30):
    chain = _random_tree(rng, int(rng.integers(2, 30)))
    ssa = K._translate(chain, 0, torch.float32, {})
    if ssa is None:
      continue
    folded = K.fold_scalars(ssa)
    alloc = K.allocate(folded)
    if alloc is None:
      continue
    fitted += 1
    assert len(folded.instrs) == len(alloc.instrs)
    _check_no_clobber(folded, alloc)
    torch.testing.assert_close(K.evaluate_program(alloc, x, []),
                               K.evaluate_program(ssa, x, []), rtol=0,
                               atol=0, equal_nan=True)
  assert fitted >= 10


def _ref_sum(host, f, jdtype, acc):
  import jax.numpy as jnp
  from spartan_tpu.backend.kernels import fused_reduce as ref_kernels
  return float(ref_kernels.fused_sum(jnp.asarray(host).astype(jdtype), f,
                                     scalars=[], acc_dtype=acc,
                                     interpret=True))


@pytest.mark.parametrize("main, acc", [("float32", "float64"),
                                       ("float32", "float32"),
                                       ("bfloat16", "float32")])
@pytest.mark.parametrize("name", sorted(NEW_OPS))
def test_plain_k1_matches_the_reference_kernel(name, main, acc):
  import jax.numpy as jnp
  f_maker, domain = NEW_OPS[name]
  f = f_maker(jnp)
  host = _host(domain)
  dtype = getattr(torch, main)
  tacc = getattr(torch, acc)
  program = K.plan(_chain(name), 0, dtype, {})
  before = K.counts["plain_runs"]
  x = torch.from_numpy(host).to(dtype)
  got = float(K.fused_sum(x, program, [], tacc))
  assert K.counts["plain_runs"] == before + 1
  want = _ref_sum(host, f, getattr(jnp, main), getattr(jnp, acc))
  scale = float(K.evaluate_program(program, x, []).double().abs().sum())
  if main == "bfloat16":
    tol = 2.0 ** -8
  elif acc == "float32":
    tol = 2e-5
  else:
    tol = 1e-12 if name in EXACT_OPS else 1e-6
  assert abs(got - want) <= tol * scale, (got, want, scale)


EPILOGUES = {"tanh": (torch.tanh, "tanh"),
             "sin": (lambda a: torch.sin(a * 0.5), "sin"),
             "floor": (lambda a: torch.floor(a * 3.0), "floor")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_k2_epilogue_against_the_reference(name, dtype):
  import jax.numpy as jnp
  from spartan_tpu.backend.kernels import matmul as ref_matmul
  fn, op = EPILOGUES[name]
  program = K2.plan_epilogue(fn)
  assert program is not None and K.OPS[op] in [o for o, *_ in program.instrs]
  rng = np.random.default_rng(11)
  a = rng.standard_normal((24, 40)).astype(np.float32)
  b = rng.standard_normal((40, 16)).astype(np.float32)
  ta = torch.from_numpy(a).to(getattr(torch, dtype))
  tb = torch.from_numpy(b).to(getattr(torch, dtype))
  before = K2.counts["plain_runs"]
  got = K2.matmul(ta, tb, epilogue=fn).float().numpy()
  assert K2.counts["plain_runs"] == before + 1
  jfn = {"tanh": jnp.tanh, "sin": lambda v: jnp.sin(v * 0.5),
         "floor": lambda v: jnp.floor(v * 3.0)}[name]
  ja, jb = jnp.asarray(a), jnp.asarray(b)
  if dtype == "bfloat16":
    ja, jb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
  want = np.asarray(ref_matmul.matmul(ja, jb, epilogue=jfn,
                                      interpret=True)).astype(np.float32)
  # the products agree to float32 summation order; the epilogue then
  # rounds (floor: a product within that of an integer may round either
  # way, so one step is allowed there)
  if name == "floor":
    assert np.abs(got - want).max() <= 1.0
    assert np.mean(got == want) > 0.97
  elif dtype == "float32":
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  else:
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
  # the program's plain evaluation is the epilogue's own
  acc = torch.from_numpy(a @ b)
  torch.testing.assert_close(K.evaluate_program(program, acc, []), fn(acc),
                             rtol=0, atol=0)
