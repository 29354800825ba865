"""The op program's passes on the CPU: scalar folding and register
allocation (``fused_reduce.fold_scalars``/``allocate``), which K1's kernel
and K2's epilogue both read, and the choice of float registers.

Every comparison here is exact (bit for bit, NaN equal to NaN): folding and
allocation rename where values live, never what an instruction computes.
"""

import pathlib

import numpy as np
import pytest
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.backend.kernels import matmul as K2
from spartan_tpu_torch.expr.base import Aval
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def call(name, *deps):
  return FnCallExpr(UFUNCS[name], list(deps))


V, S = LocalInput(0), LocalInput(1)
_TWO_V = call("multiply", V, LocalConst(2.0))

# the chains of tests/test_torch_kernels.py, test_torch_cuda.py and
# chip_smoke.py: name → (chain, takes the scalar S)
CHAINS = {
    "identity": (None, False),
    "one_plus_2v": (call("add", LocalConst(1.0), _TWO_V), False),
    "abs_one_plus_2v": (call("absolute", call("add", LocalConst(1.0), _TWO_V)),
                        False),
    "exp_neg_v2": (call("exp", call("multiply", call("negative", V), V)),
                   False),
    "max_vs_zero": (call("maximum", call("multiply", V, S), LocalConst(0.0)),
                    True),
    "max_vs_quarter": (call("maximum", call("multiply", V, S),
                            LocalConst(0.25)), True),
    "max_vs_sqrt_s": (call("maximum", call("multiply", V, S), call("sqrt", S)),
                      True),
    "s_plus_2v": (call("add", S, _TWO_V), True),
}
BINARY = ("add", "subtract", "multiply", "true_divide", "maximum", "minimum")
UNARY = ("negative", "absolute", "square", "sqrt", "exp", "log")


def _ssa(chain, dtype, scalars):
  avals = {k: Aval.of(v) for k, v in scalars.items()}
  return K._translate(chain, 0, dtype, avals)


def _x(dtype, seed=3):
  host = np.random.default_rng(seed).uniform(-2.0, 3.0, (7, 11))
  return torch.from_numpy(host.astype(np.float32)).to(dtype)


def _scalar(kind):
  """S as a strong float32 or float64 0-d tensor, or a weak Python float."""
  return {"f32": torch.tensor(0.7, dtype=torch.float32),
          "f64": torch.tensor(0.7, dtype=torch.float64),
          "weak": 0.7}[kind]


def _demand(program) -> int:
  """Registers the program needs at its worst instruction, counted from
  its SSA form alone: the values defined before the instruction and read
  after it (the output is read at the end), plus the one it writes."""
  last = {program.out: len(program.instrs)}
  for k, (op, _, _, a, b) in enumerate(program.instrs):
    for src in K._sources(op, a, b):
      last[src] = max(last.get(src, -1), k)
  worst = 0
  for k in range(len(program.instrs)):
    live = sum(1 for _, _, d, _, _ in program.instrs[:k]
               if last.get(d, -1) > k)
    worst = max(worst, live + 1)
  return worst


def _check_no_clobber(ssa, alloc):
  """Walk both forms side by side: each register operand of the allocated
  program must hold, when it is read, the SSA value it stands for."""
  assert len(ssa.instrs) == len(alloc.instrs)
  holds = {}
  for (op, dt, dst, a, b), (aop, adt, adst, aa, ab) in zip(ssa.instrs,
                                                           alloc.instrs):
    assert (op, dt) == (aop, adt)
    assert 0 <= adst < K.N_REGS
    if op >= 3:
      pairs = [(a, aa)] + ([(b, ab)] if K._BINARY_OPS[op] else [])
      for want, reg in pairs:
        if want < 0:  # a folded scalar stays a scalar
          assert reg == want
        else:
          assert holds[reg] == want, f"register {reg} was overwritten"
    holds[adst] = dst
  assert holds[alloc.out] == ssa.out


def _same(a, b):
  torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["f32", "f64", "weak"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_allocated_chain_matches_ssa_bit_for_bit(name, dtype, kind):
  chain, takes_s = CHAINS[name]
  scalars = [_scalar(kind)] if takes_s else []
  slots = dict(enumerate(scalars, start=1))
  ssa = _ssa(chain, dtype, slots)
  folded = K.fold_scalars(ssa)
  alloc = K.allocate(folded)
  assert alloc is not None and K.plan(chain, 0, dtype, slots) is not None
  _check_no_clobber(folded, alloc)
  assert not any(op in (K.LOADI, K.LOADS) for op, *_ in alloc.instrs)
  x = _x(dtype)
  want = K.evaluate_program(ssa, x, scalars)
  _same(K.evaluate_program(folded, x, scalars), want)
  _same(K.evaluate_program(alloc, x, scalars), want)
  if chain is not None:
    _same(want, chain.evaluate([x] + scalars))


def test_epilogue_program_is_folded_and_allocated():
  program = K2.plan_epilogue(lambda a: torch.clamp_min(a, 0.0))
  assert [op for op, *_ in program.instrs] == [K.LOADX, K.OPS["maximum"]]
  assert program.instrs[1][4] == K.scalar_operand(K.LOADI, 0)
  assert program.out == 0 and program.float_regs


def _random_tree(rng, budget):
  """A random chain of at most ``budget`` nodes over V, S and constants."""
  if budget <= 1 or rng.random() < 0.2:
    r = rng.random()
    if r < 0.6:
      return V
    if r < 0.85:
      return LocalConst(float(np.round(rng.uniform(-3.0, 3.0), 3)))
    return S
  name = rng.choice(BINARY + UNARY)
  if name in UNARY:
    return call(name, _random_tree(rng, budget - 1))
  left = int(rng.integers(1, budget - 1)) if budget > 2 else 1
  return call(name, _random_tree(rng, left),
              _random_tree(rng, budget - 1 - left))


@pytest.mark.parametrize("seed", range(8))
def test_random_trees_allocate_exactly_when_they_fit(seed):
  """Random trees of up to MAX_INSTR instructions: allocation succeeds
  exactly when the SSA program's register demand is at most N_REGS, never
  overwrites a live value, and gives the SSA program's bits."""
  rng = np.random.default_rng(seed)
  x = _x(torch.float32, seed)
  fitted = refused = 0
  for _ in range(40):
    chain = _random_tree(rng, int(rng.integers(2, 40)))
    kind = rng.choice(["f32", "f64", "weak"])
    scalars = [_scalar(kind)]
    ssa = _ssa(chain, torch.float32, {1: scalars[0]})
    if ssa is None:  # a tree without V is not a program
      continue
    assert len(ssa.instrs) <= K.MAX_INSTR
    folded = K.fold_scalars(ssa)
    alloc = K.allocate(folded)
    assert (alloc is None) == (_demand(folded) > K.N_REGS)
    if alloc is None:
      refused += 1
      continue
    fitted += 1
    _check_no_clobber(folded, alloc)
    want = K.evaluate_program(ssa, x, scalars)
    _same(K.evaluate_program(alloc, x, scalars), want)
    _same(want, chain.evaluate([x] + scalars))
    assert alloc.float_regs == all(
        dt != K.DTYPE_CODES[torch.float64] for op, dt, *_ in ssa.instrs
        if op >= 3)
  assert fitted >= 20


def _deep_chain(depth):
  """v*c1 + (v*c2 + (... + v*c_depth)): each left product stays live while
  the right one is computed, so it needs ``depth`` registers (v's is free
  again once the last product has read it)."""
  chain = call("multiply", V, LocalConst(float(depth)))
  for c in range(depth - 1, 0, -1):
    chain = call("add", call("multiply", V, LocalConst(float(c))), chain)
  return chain


def test_chain_needing_more_registers_is_refused_and_counted():
  fits = _deep_chain(K.N_REGS)
  assert _demand(K.fold_scalars(_ssa(fits, torch.float32, {}))) == K.N_REGS
  assert K.plan(fits, 0, torch.float32, {}) is not None
  deep = _deep_chain(K.N_REGS + 1)
  ssa = _ssa(deep, torch.float32, {})
  assert ssa is not None and len(ssa.instrs) <= K.MAX_INSTR
  before = K.counts["routed_plain"]
  assert K.plan(deep, 0, torch.float32, {}) is None
  assert K.counts["routed_plain"] == before + 1
  # the same structure as a matmul epilogue is not fused either
  assert K2.plan_epilogue(
      lambda a: a * 1.0 + (a * 2.0 + (a * 3.0 + (a * 4.0 + (a * 5.0 + (
          a * 6.0 + (a * 7.0 + (a * 8.0 + a * 9.0)))))))) is None
  assert K2.plan_epilogue(
      lambda a: a * 1.0 + (a * 2.0 + (a * 3.0 + (a * 4.0 + (a * 5.0 + (
          a * 6.0 + (a * 7.0 + a * 8.0))))))) is not None
  # through the expression layer (abs keeps the affine rewrite out): the
  # reduction's plain path, counted
  host = _x(torch.float32).numpy()
  b = sp.from_numpy(host)
  expr = abs(b * float(K.N_REGS + 1))
  for c in range(K.N_REGS, 0, -1):
    expr = abs(b * float(c)) + expr
  before = dict(K.counts)
  got = float(expr.sum().glom())
  assert K.counts["routed_plain"] == before["routed_plain"] + 1
  assert K.counts["plain_runs"] == before["plain_runs"]
  want = (np.abs(host.astype(np.float64)) * sum(range(1, K.N_REGS + 2))).sum()
  np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_float_registers_exactly_without_float64_instructions(dtype):
  strong = CHAINS["s_plus_2v"][0]
  for kind, want_float in (("f64", False), ("f32", True), ("weak", True)):
    p = K.plan(strong, 0, dtype, {1: _scalar(kind)})
    has_f64 = any(dt == K.DTYPE_CODES[torch.float64]
                  for op, dt, *_ in p.instrs if op >= 3)
    assert p.float_regs == (not has_f64) == want_float
  for name, (chain, takes_s) in CHAINS.items():
    if not takes_s:
      assert K.plan(chain, 0, dtype, {}).float_regs


def test_fold_keeps_a_scalar_output_and_unfolded_loads():
  """A load that is the program's output stays an instruction; an
  evaluation of every form agrees."""
  ssa = K.Program([(K.LOADX, 1, 0, 0, 0), (K.LOADI, 0, 1, 0, 0)], 1,
                  [("const", 2.5)], [], torch.float64)
  folded = K.fold_scalars(ssa)
  assert folded.instrs == ssa.instrs
  alloc = K.allocate(folded)
  x = _x(torch.float32)
  _same(K.evaluate_program(alloc, x, []), K.evaluate_program(ssa, x, []))


# -- the opcodes of floor division, remainder and power -----------------------

NEW_CHAINS = {
    "v_pow_3": (call("power", V, LocalConst(3.0)), lambda v: v ** 3.0),
    "v_floordiv": (call("floor_divide", V, LocalConst(0.3)),
                   lambda v: v // 0.3),
    "v_mod": (call("remainder", V, LocalConst(0.7)), lambda v: v % 0.7),
    "abs_v_pow_s": (call("power", call("absolute", V), S), None),
    "mod_of_square": (call("remainder", call("square", V), LocalConst(1.1)),
                      None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("name", sorted(NEW_CHAINS))
def test_new_opcodes_translate_and_match_the_chain(name, dtype):
  """power, floor_divide and remainder are instructions of the program,
  which computes exactly what the chain computes with torch ops."""
  chain, _ = NEW_CHAINS[name]
  scalars = [_scalar("weak")] if name == "abs_v_pow_s" else []
  slots = dict(enumerate(scalars, start=1))
  program = K.plan(chain, 0, dtype, slots)
  if dtype == torch.float64:  # float64 instructions: no rare-op variant
    assert program is None and K._translate(chain, 0, dtype, {
        k: Aval.of(v) for k, v in slots.items()}) is not None
    return
  assert program is not None
  ops = {op for op, *_ in program.instrs}
  want_ops = {"v_pow_3": {K.OPS["power"]}, "v_floordiv": {K.OPS["floor_divide"]},
              "v_mod": {K.OPS["remainder"]},
              "abs_v_pow_s": {K.OPS["absolute"], K.OPS["power"]},
              "mod_of_square": {K.OPS["square"], K.OPS["remainder"]}}[name]
  assert want_ops <= ops
  x = _x(dtype)
  got = K.evaluate_program(program, x, scalars)
  want = chain.evaluate([x] + scalars)
  if "pow" in name:
    # the program's pow reads its exponent as a tensor (pow(x, y), as the
    # kernel computes it); the chain's torch.pow(x, 3.0) takes torch's
    # scalar path (x * x * x): ulps apart
    torch.testing.assert_close(got, want, equal_nan=True)
  else:
    _same(got, want)


@pytest.mark.parametrize("exponent, op", [(2.0, "square"), (2, "square"),
                                          (0.5, "sqrt"), (3.0, "power"),
                                          (True, "power")])
@pytest.mark.parametrize("form", ["const", "weak"])
def test_power_with_a_known_exponent_takes_the_fast_op(form, exponent, op):
  """A power whose exponent is 2 or 0.5 (a constant, or a weak scalar
  whose value keys the plan) is the square or square-root instruction, as
  torch's scalar fast path computes it."""
  if form == "const":
    chain, slots = call("power", V, LocalConst(exponent)), {}
  else:
    chain, slots = call("power", V, S), {1: exponent}
  program = K.plan(chain, 0, torch.float32, slots)
  assert [o for o, *_ in program.instrs][1:] == [K.OPS[op]]
  x = torch.from_numpy(np.abs(_x(torch.float32).numpy()))
  scalars = [] if form == "const" else [exponent]
  got = K.evaluate_program(program, x, scalars)
  want = chain.evaluate([x] + scalars)
  if op == "power":  # pow(x, tensor) against torch's scalar path
    torch.testing.assert_close(got, want)
  else:  # the fast ops give torch's scalar-path bits
    _same(got, want)
  # another value of the weak exponent is another plan
  if form == "weak":
    other = K.plan(chain, 0, torch.float32, {1: 1.5})
    assert [o for o, *_ in other.instrs][1:] == [K.OPS["power"]]


def test_integer_floor_division_leaves_the_program():
  i = sp.from_numpy(np.arange(-6, 6, dtype=np.int32).reshape(3, 4))
  before = K.counts["routed_plain"]
  got = int((i // 4).sum().glom())
  assert got == int((np.arange(-6, 6) // 4).sum())
  assert K.counts["routed_plain"] == before  # an int64 sum: no kernel gate


@pytest.mark.parametrize("dt", sorted(K.DTYPE_CODES.values()))
@pytest.mark.parametrize("op", list(range(K.OPS["power"] + 1)))
def test_every_opcode_and_dtype_pack_and_unpack(op, dt):
  """The Python mirror of op_program.cuh's packed word: every opcode and
  dtype code, registers and folded scalars at their extremes, round-trip,
  and the fields sit where the C unpacking reads them."""
  for dst, a, b in ((0, 0, 0), (K.N_REGS - 1, -1 - K.MAX_IMM - 15, 7),
                    (3, -1, -1 - K.MAX_IMM), (K.N_REGS - 1, 5, -32)):
    code = K.pack_instruction(op, dt, dst, a, b)
    assert 0 <= code < 1 << 32
    assert K.unpack_instruction(code) == (op, dt, dst, a, b)
    assert code & 63 == op and (code >> 6) & 3 == dt
    assert (code >> 8) & 255 == dst
  with pytest.raises(ValueError):
    K.pack_instruction(64, 0, 0, 0, 0)
  with pytest.raises(ValueError):
    K.pack_instruction(op, 4, 0, 0, 0)


def test_the_largest_opcode_fits_the_packed_word():
  assert max(K.OPS.values()) < 1 << K.OP_BITS
  assert max(K.DTYPE_CODES.values()) < 1 << K.DT_BITS
  header = (pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
            / "op_program.cuh").read_text()
  for name, code in (("OP_FLOORDIV", K.OPS["floor_divide"]),
                     ("OP_MOD", K.OPS["remainder"]),
                     ("OP_POW", K.OPS["power"])):
    assert f"{name} = {code}," in header
  assert "op = code & 63, dt = (code >> 6) & 3" in header


def test_epilogue_takes_the_new_ops():
  for fn, op in ((lambda a: a % 2.0, "remainder"),
                 (lambda a: a // 3.0, "floor_divide"),
                 (lambda a: a ** 1.5, "power"),
                 (lambda a: torch.pow(a, 2.0), "square"),
                 (lambda a: a ** 0.5, "sqrt")):
    program = K2.plan_epilogue(fn)
    assert program is not None
    assert [o for o, *_ in program.instrs][-1] == K.OPS[op]
    acc = torch.linspace(0.5, 7.0, 29)
    torch.testing.assert_close(K.evaluate_program(program, acc, []), fn(acc))


@pytest.mark.parametrize("acc", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("name", ["v_pow_3", "v_floordiv", "v_mod"])
def test_plain_k1_matches_the_reference_kernel_on_new_ops(name, acc):
  """K1's plain version against the reference's ``fused_sum`` in interpret
  mode: rtol 1e-5 with a float32 accumulator (another order), 1e-6 with
  a float64 one (the per-element values agree to the last bit, or an ulp
  for pow, as with exp)."""
  import jax.numpy as jnp
  from spartan_tpu.backend.kernels import fused_reduce as ref_kernels
  chain, jfn = NEW_CHAINS[name]
  host = np.random.default_rng(7).uniform(-1.0, 2.0, (64, 256)).astype(
      np.float32)
  program = K.plan(chain, 0, torch.float32, {})
  before = K.counts["plain_runs"]
  got = K.fused_sum(torch.from_numpy(host), program, [], acc)
  assert K.counts["plain_runs"] == before + 1
  jacc = jnp.float32 if acc == torch.float32 else jnp.float64
  want = ref_kernels.fused_sum(jnp.asarray(host), jfn, scalars=[],
                               acc_dtype=jacc, interpret=True)
  np.testing.assert_allclose(float(got), float(want),
                             rtol=1e-5 if acc == torch.float32 else 1e-6)


def test_rare_ops_beside_a_float64_instruction_are_refused_and_counted():
  """Floor division, remainder and power run only in float registers: a
  program that would need double registers takes the plain path."""
  chain = call("remainder", call("add", V, S), LocalConst(0.7))
  assert K.plan(chain, 0, torch.float32, {1: _scalar("f32")}) is not None
  before = K.counts["routed_plain"]
  assert K.plan(chain, 0, torch.float32, {1: _scalar("f64")}) is None
  assert K.counts["routed_plain"] == before + 1
  no_rare = call("add", V, S)
  assert not K.plan(no_rare, 0, torch.float32, {1: _scalar("f64")}).float_regs
