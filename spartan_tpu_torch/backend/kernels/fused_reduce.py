"""Fused elementwise + full-sum kernel (K1) and its plain torch version.

Replaces ``spartan_tpu/backend/kernels/fused_reduce.py:fused_sum``:
``sum(f(x, *scalars))`` in one read of ``x``, where ``f`` is the fused
``LocalExpr`` chain that ``ReduceMapFusion`` spliced into a full sum and
the scalars are the region's 0-d operands.

The chain reaches the GPU as an *op program*: :func:`plan` translates the
``LocalExpr`` tree into a flat list of instructions over a fixed op table
(add, subtract, multiply, true_divide, negative, absolute, square, sqrt,
exp, log, maximum, minimum, floor_divide, remainder, power), keyed on the
ufunc names that ``map2``'s
wrappers keep (and on the callable being the port's own ufunc).  Each
instruction carries an opcode, the dtype it computes in (the dtype the
plain torch evaluation of that node has), a destination register and
source registers or slots.  Leaves are the big operand's element
(``LOADX``), a 0-d device tensor (``LOADS``, read from a float64 vector)
and an immediate (``LOADI``: a weak Python scalar or a ``LocalConst``).

The translation is in SSA form (one register an instruction).
:func:`fold_scalars` folds each immediate and device scalar into the
instructions that read it (a negative operand), and :func:`allocate` maps
the rest onto ``N_REGS`` registers by liveness, reusing a register once its
value is dead, so that the kernel keeps its register file, sized to the
program, in machine registers.  A program whose instructions all compute in
float32, bfloat16 or float16 runs in ``float`` registers
(``Program.float_regs``); one with a float64 instruction in ``double``.
The C entry point picks that variant, and the grid, from the program.

A chain outside the table — another op, an integer or complex dtype, more
than ``MAX_INSTR`` instructions, ``MAX_IMM`` immediates or
``MAX_DEV_SCALARS`` device scalars, more than ``N_REGS`` values live at
once, floor division, remainder or power (``RARE_OPS``) beside a float64
instruction —
is refused up front by :func:`plan` and counted in
``counts["routed_plain"]``; the reduction then takes its plain path.
Nothing is decided by catching an exception.

:func:`fused_sum` routes by the tensor's device: a CUDA tensor launches
``csrc/fused_reduce.cu`` (or raises), a CPU tensor runs
:func:`fused_sum_plain`, which evaluates the same program with torch ops.
The kernel is bound by the bytes of one read of ``x``; the source note in
the ``.cu`` file says how its design answers that.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from spartan_tpu_torch.expr.base import Aval
from spartan_tpu_torch.expr.local import (FnCallExpr, LocalConst, LocalExpr,
                                          LocalInput, _postorder)
from spartan_tpu_torch.expr.map import UFUNCS

MAX_INSTR = 64
MAX_IMM = 16
MAX_DEV_SCALARS = 16
N_REGS = 8  # SP_NREG in csrc/op_program.cuh
THREADS = 256
# room for the kernel's partial sums, in blocks an SM: at least the grid
# that csrc/fused_reduce.cu picks (twice the blocks its launch bounds fit,
# 4 or 6 an SM)
PARTIALS_PER_SM = 8

LOADX, LOADS, LOADI = 0, 1, 2
_FIRST_OP = 3  # opcodes from here on compute; below, they load
OPS = {"add": 3, "subtract": 4, "multiply": 5, "true_divide": 6,
       "negative": 7, "absolute": 8, "square": 9, "sqrt": 10, "exp": 11,
       "log": 12, "maximum": 13, "minimum": 14, "floor_divide": 15,
       "remainder": 16, "power": 17}
_ARITY = {name: (2 if name in ("add", "subtract", "multiply", "true_divide",
                               "maximum", "minimum", "floor_divide",
                               "remainder", "power") else 1)
          for name in OPS}
# a power whose exponent is one of these known scalars takes the op that
# torch's (and NumPy's) scalar fast path takes
_POWERS = {2.0: "square", 0.5: "sqrt"}
# the "rare" ops: only the kernel variants built for them carry their code
# (program_has_rare in csrc/op_program.cuh), and only in float registers
RARE_OPS = frozenset(OPS[name] for name in ("floor_divide", "remainder",
                                            "power"))
_BINARY_OPS = {code: _ARITY[name] == 2 for name, code in OPS.items()}
DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2,
               torch.float16: 3}
_CODE_DTYPES = {c: d for d, c in DTYPE_CODES.items()}

OP_BITS, DT_BITS = 6, 2  # the packed word of sp_prog::decode


def pack_instruction(op: int, dt: int, dst: int, a: int, b: int) -> int:
  """One instruction as the kernels' shared-memory word (``sp_prog::decode``
  in csrc/op_program.cuh): op | dt << 6 | dst << 8 | b << 16 | a << 24,
  ``a`` and ``b`` as signed bytes."""
  if not (0 <= op < 1 << OP_BITS and 0 <= dt < 1 << DT_BITS
          and 0 <= dst < 256 and -128 <= a < 128 and -128 <= b < 128):
    raise ValueError(f"instruction {(op, dt, dst, a, b)} does not pack")
  return (op | dt << OP_BITS | dst << 8 | (b & 255) << 16
          | (a & 255) << 24)


def unpack_instruction(code: int) -> Tuple[int, int, int, int, int]:
  """``(op, dt, dst, a, b)`` of a packed word, as ``run_program`` reads it."""
  def signed(byte):
    return byte - 256 if byte >= 128 else byte
  return (code & (1 << OP_BITS) - 1, code >> OP_BITS & (1 << DT_BITS) - 1,
          code >> 8 & 255, signed(code >> 24 & 255), signed(code >> 16 & 255))


counts = {"launches": 0, "plain_runs": 0, "routed_plain": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


class _ProgramStruct(ctypes.Structure):
  """Mirror of ``struct Program`` in ``csrc/op_program.cuh``."""
  _fields_ = [("n", ctypes.c_int32), ("out", ctypes.c_int32),
              ("op", ctypes.c_int8 * MAX_INSTR),
              ("dt", ctypes.c_int8 * MAX_INSTR),
              ("dst", ctypes.c_int8 * MAX_INSTR),
              ("a", ctypes.c_int8 * MAX_INSTR),
              ("b", ctypes.c_int8 * MAX_INSTR),
              ("imm", ctypes.c_double * MAX_IMM)]


class Program:
  """A fused chain as a flat op program.

  ``instrs`` holds ``(opcode, dtype_code, dst, a, b)``: a load's ``a`` is
  its slot, a compute instruction's ``a``/``b`` a register or, negative, a
  folded scalar (:func:`scalar_operand`); ``imm_sources``
  says where each immediate comes from (``("scalar", k)``: the k-th scalar
  operand, a weak Python number; ``("const", v)``); ``dev_scalars`` lists
  the scalar operands read from device memory, in slot order; ``dtype`` is
  the chain's result dtype."""

  __slots__ = ("instrs", "out", "imm_sources", "dev_scalars", "dtype")

  def __init__(self, instrs, out, imm_sources, dev_scalars, dtype):
    self.instrs: List[Tuple[int, int, int, int, int]] = instrs
    self.out: int = out
    self.imm_sources: List[Tuple[str, Any]] = imm_sources
    self.dev_scalars: List[int] = dev_scalars
    self.dtype: torch.dtype = dtype

  @property
  def float_regs(self) -> bool:
    """True when no instruction computes in float64: the kernel then keeps
    its registers in ``float`` (immediates and device scalars rounded to
    float once, at their load), which gives the bits of ``double``
    registers, since every value such a program computes is a float."""
    return all(dt != DTYPE_CODES[torch.float64]
               for op, dt, _, _, _ in self.instrs if op >= _FIRST_OP)

  def immediates(self, scalars: Sequence[Any]) -> List[float]:
    return [float(scalars[v]) if kind == "scalar" else float(v)
            for kind, v in self.imm_sources]

  def host_struct(self, scalars: Sequence[Any]) -> _ProgramStruct:
    s = _ProgramStruct()
    s.n = len(self.instrs)
    s.out = self.out
    for i, (op, dt, dst, a, b) in enumerate(self.instrs):
      s.op[i], s.dt[i], s.dst[i], s.a[i], s.b[i] = op, dt, dst, a, b
    for i, v in enumerate(self.immediates(scalars)):
      s.imm[i] = v
    return s


class _Reg:
  """Translation-time value: its register, its abstract value (a meta
  tensor, or a Python scalar for weak values) and, for an immediate whose
  value the plan knows, that value."""
  __slots__ = ("reg", "meta", "value")

  def __init__(self, reg: int, meta: Any, value: Any = None):
    self.reg = reg
    self.meta = meta
    self.value = value


def _translate(local_op: Optional[LocalExpr], main_slot: int,
               main_dtype: torch.dtype, scalar_avals: Dict[int, Aval],
               known: Optional[Dict[int, Any]] = None) -> Optional[Program]:
  """The op program of ``local_op``, or None when the chain is outside the
  op table (the up-front predicate: no exception decides the route).
  ``known`` gives the values of weak scalar slots that a power reads as
  its exponent (:func:`power_slots`), for the fast paths of ``_POWERS``."""
  known = known or {}
  if main_dtype not in DTYPE_CODES:
    return None
  instrs: List[Tuple[int, int, int, int, int]] = []
  imm_sources: List[Tuple[str, Any]] = []
  dev_scalars: List[int] = []
  scalar_order = sorted(scalar_avals)
  slot_regs: Dict[int, _Reg] = {}

  def emit(op: int, dt: int, a: int = 0, b: int = 0) -> Optional[int]:
    if len(instrs) >= MAX_INSTR:
      return None
    instrs.append((op, dt, len(instrs), a, b))
    return len(instrs) - 1

  def leaf(node: LocalExpr) -> Optional[_Reg]:
    if isinstance(node, LocalInput):
      hit = slot_regs.get(node.idx)
      if hit is not None:
        return hit
      value = None
      if node.idx == main_slot:
        reg = emit(LOADX, DTYPE_CODES[main_dtype])
        meta: Any = torch.empty((1,), dtype=main_dtype, device="meta")
      elif node.idx in scalar_avals:
        aval = scalar_avals[node.idx]
        k = scalar_order.index(node.idx)
        meta = aval.abstract_value()
        if aval.weak:
          if aval.dtype.is_complex or len(imm_sources) >= MAX_IMM:
            return None
          reg = emit(LOADI, 0, len(imm_sources))
          imm_sources.append(("scalar", k))
          value = known.get(node.idx)
        else:
          if len(dev_scalars) >= MAX_DEV_SCALARS:
            return None
          reg = emit(LOADS, 0, len(dev_scalars))
          dev_scalars.append(k)
      else:
        return None
      if reg is None:
        return None
      slot_regs[node.idx] = _Reg(reg, meta, value)
      return slot_regs[node.idx]
    if isinstance(node, LocalConst):
      v = node.value
      if type(v) not in (bool, int, float) or len(imm_sources) >= MAX_IMM:
        return None
      reg = emit(LOADI, 0, len(imm_sources))
      if reg is None:
        return None
      imm_sources.append(("const", v))
      return _Reg(reg, Aval.of(v).abstract_value(), v)
    return None

  def call(node: FnCallExpr, deps: List[Optional[_Reg]]) -> Optional[_Reg]:
    name = getattr(node.fn, "__name__", "")
    # the port's own ufunc under that name, not just any callable named so
    if (any(d is None for d in deps) or name not in OPS
        or UFUNCS.get(name) is not node.fn or node.kw
        or len(deps) != _ARITY[name]):
      return None
    meta = node.fn(*[d.meta for d in deps])
    dtype = Aval.of(meta).dtype
    if dtype not in DTYPE_CODES:
      return None  # integer, bool or complex node: not in the program
    if name == "power" and deps[1].value in _POWERS and not isinstance(
        deps[1].value, bool):
      name, deps = _POWERS[deps[1].value], deps[:1]
    b = deps[1].reg if len(deps) == 2 else 0
    reg = emit(OPS[name], DTYPE_CODES[dtype], deps[0].reg, b)
    return None if reg is None else _Reg(reg, meta)

  if local_op is None:
    local_op = LocalInput(main_slot)
  root = _postorder(local_op, leaf, call)
  if root is None or main_slot not in slot_regs:
    return None
  return Program(instrs, root.reg, imm_sources, dev_scalars,
                 Aval.of(root.meta).dtype)


def _sources(op: int, a: int, b: int) -> Tuple[int, ...]:
  """The registers an instruction reads (a load reads a slot, and a
  negative operand names a scalar: neither is a register)."""
  if op < _FIRST_OP:
    return ()
  return tuple(r for r in ((a, b) if _BINARY_OPS[op] else (a,)) if r >= 0)


def scalar_operand(op: int, slot: int) -> int:
  """The operand code of a folded load: ``-1 - k`` names immediate k,
  ``-1 - MAX_IMM - k`` device scalar k (``SP_SCAL`` in op_program.cuh)."""
  return -1 - slot if op == LOADI else -1 - MAX_IMM - slot


def fold_scalars(program: Program) -> Program:
  """``program`` without the LOADI/LOADS instructions whose value feeds
  only compute instructions: their readers name the scalar directly
  (:func:`scalar_operand`), which the kernel reads as one value for all
  elements, so it takes no register and no instruction of its own."""
  loads = {dst: scalar_operand(op, a) for op, _, dst, a, _ in program.instrs
           if op in (LOADI, LOADS) and dst != program.out}
  instrs = []
  for op, dt, dst, a, b in program.instrs:
    if dst in loads:
      continue
    if op >= _FIRST_OP:
      a = loads.get(a, a)
      b = loads.get(b, b) if _BINARY_OPS[op] else 0
    instrs.append((op, dt, dst, a, b))
  return Program(instrs, program.out, program.imm_sources,
                 program.dev_scalars, program.dtype)


def allocate(program: Program, n_regs: int = N_REGS) -> Optional[Program]:
  """``program`` with its registers mapped onto ``n_regs`` by liveness, or
  None when more than ``n_regs`` values are live at once.

  A value's register is freed after the instruction that reads it last (the
  output stays live to the end; a value no one reads is freed at once), and
  an instruction takes the lowest free register, which may be one its own
  operands just freed: the kernel reads the operands before it writes."""
  last: Dict[int, int] = {}
  for k, (op, _, _, a, b) in enumerate(program.instrs):
    for src in _sources(op, a, b):
      last[src] = k
  last[program.out] = len(program.instrs)
  free = list(range(n_regs))
  phys: Dict[int, int] = {}
  instrs: List[Tuple[int, int, int, int, int]] = []
  for k, (op, dt, dst, a, b) in enumerate(program.instrs):
    srcs = _sources(op, a, b)
    binary = op >= _FIRST_OP and _BINARY_OPS[op]
    pa = phys[a] if op >= _FIRST_OP and a >= 0 else a
    pb = (phys[b] if b >= 0 else b) if binary else 0
    for src in set(srcs):
      if last[src] == k:
        free.append(phys[src])
    if not free:
      return None
    reg = min(free)
    free.remove(reg)
    phys[dst] = reg
    if dst not in last:  # never read
      free.append(reg)
    instrs.append((op, dt, reg, pa, pb))
  return Program(instrs, phys[program.out], program.imm_sources,
                 program.dev_scalars, program.dtype)


_plans: Dict[Tuple, Optional[Program]] = {}
_power_slots: Dict[Tuple, Tuple[int, ...]] = {}


def power_slots(local_op: Optional[LocalExpr]) -> Tuple[int, ...]:
  """The input slots that a ``power`` in ``local_op`` reads directly as its
  exponent (memoized by the chain's signature)."""
  if local_op is None:
    return ()
  key = local_op.signature()
  if key not in _power_slots:
    if len(_power_slots) > 1024:
      _power_slots.clear()
    slots, stack, seen = set(), [local_op], set()
    while stack:
      node = stack.pop()
      if not isinstance(node, FnCallExpr) or id(node) in seen:
        continue
      seen.add(id(node))
      if (getattr(node.fn, "__name__", "") == "power" and len(node.deps) == 2
          and isinstance(node.deps[1], LocalInput)):
        slots.add(node.deps[1].idx)
      stack.extend(node.deps)
    _power_slots[key] = tuple(sorted(slots))
  return _power_slots[key]


def plan(local_op: Optional[LocalExpr], main_slot: int,
         main_dtype: torch.dtype, scalars: Dict[int, Any]) -> Optional[Program]:
  """Translate ``local_op`` for a main operand in ``main_slot`` and 0-d
  ``scalars`` (slot → value: a tensor, or a weak Python scalar), with its
  registers allocated.  Returns None — counted in
  ``counts["routed_plain"]`` — when the chain cannot be expressed; the
  caller then takes its plain path."""
  avals = {k: Aval.of(v) for k, v in scalars.items()}
  # a weak exponent's value picks the op (_POWERS): it keys the plan
  known = {k: scalars[k] for k in power_slots(local_op)
           if k in avals and avals[k].weak}
  key = (local_op.signature() if local_op is not None else None, main_slot,
         main_dtype, tuple((k, avals[k].key) for k in sorted(avals)),
         tuple(sorted(known.items())))
  if key not in _plans:
    if len(_plans) > 1024:
      _plans.clear()
    ssa = _translate(local_op, main_slot, main_dtype, avals, known)
    program = None if ssa is None else allocate(fold_scalars(ssa))
    if program is not None and not program.float_regs and any(
        op in RARE_OPS for op, *_ in program.instrs):
      program = None  # a rare op in double registers: no such variant
    _plans[key] = program
  program = _plans[key]
  if program is None:
    counts["routed_plain"] += 1
  return program


_TORCH_OPS = {
    OPS["add"]: torch.add, OPS["subtract"]: torch.sub,
    OPS["multiply"]: torch.mul, OPS["true_divide"]: torch.div,
    OPS["negative"]: torch.neg, OPS["absolute"]: torch.abs,
    OPS["square"]: lambda v: v * v, OPS["sqrt"]: torch.sqrt,
    OPS["exp"]: torch.exp, OPS["log"]: torch.log,
    OPS["maximum"]: torch.maximum, OPS["minimum"]: torch.minimum,
    OPS["floor_divide"]: torch.floor_divide,
    OPS["remainder"]: torch.remainder, OPS["power"]: torch.pow,
}


def evaluate_program(program: Program, x: torch.Tensor,
                     scalars: Sequence[Any]) -> torch.Tensor:
  """The program's elementwise value over ``x``, with torch ops: every
  instruction casts its operands to its dtype and computes there, exactly
  as the kernel does.  Reads SSA, folded and allocated programs alike."""
  imm = program.immediates(scalars)

  def scalar(op: int, slot: int) -> torch.Tensor:
    if op == LOADS:
      return scalars[program.dev_scalars[slot]].reshape(()).to(torch.float64)
    return torch.tensor(imm[slot], dtype=torch.float64, device=x.device)

  def operand(code: int) -> torch.Tensor:
    if code >= 0:
      return regs[code]
    slot = -1 - code
    return (scalar(LOADI, slot) if slot < MAX_IMM
            else scalar(LOADS, slot - MAX_IMM))

  regs: Dict[int, torch.Tensor] = {}
  for op, dt, dst, a, b in program.instrs:
    if op == LOADX:
      v = x
    elif op in (LOADS, LOADI):
      v = scalar(op, a)
    else:
      dtype = _CODE_DTYPES[dt]
      args = [operand(a).to(dtype)]
      if _BINARY_OPS[op]:
        args.append(operand(b).to(dtype))
      v = _TORCH_OPS[op](*args)
    regs[dst] = v
  return regs[program.out]


def fused_sum_plain(x: torch.Tensor, program: Program,
                    scalars: Sequence[Any], acc_dtype: torch.dtype
                    ) -> torch.Tensor:
  """Plain torch version of the kernel: the same program, then
  ``torch.sum(..., dtype=acc_dtype)``."""
  return torch.sum(evaluate_program(program, x, scalars), dtype=acc_dtype)


def fused_sum(x: torch.Tensor, program: Program, scalars: Sequence[Any] = (),
              acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """``sum(program(x, *scalars))`` as a 0-d tensor of ``acc_dtype``.

  A CUDA ``x`` launches the kernel (or raises); a CPU or meta ``x`` runs
  :func:`fused_sum_plain`."""
  if x.device.type != "cuda":
    counts["plain_runs"] += 1
    return fused_sum_plain(x, program, scalars, acc_dtype)
  return _launch(x, program, scalars, acc_dtype)


_IN_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_ACC_CODES = {torch.float64: 0, torch.float32: 1}


def _library() -> ctypes.CDLL:
  from spartan_tpu_torch.backend.kernels import build
  lib = build.load("fused_reduce")
  if lib.spartan_fused_sum.argtypes is None:
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.spartan_fused_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.spartan_fused_sum.restype = ctypes.c_int
    lib.spartan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.spartan_cuda_error_string.restype = ctypes.c_char_p
  return lib


def _launch(x: torch.Tensor, program: Program, scalars: Sequence[Any],
            acc_dtype: torch.dtype) -> torch.Tensor:
  if x.dtype not in _IN_CODES:
    raise TypeError(f"fused_sum kernel reads float32/bfloat16/float16, "
                    f"not {x.dtype}")
  if acc_dtype not in _ACC_CODES:
    raise TypeError(f"fused_sum kernel accumulates in float32/float64, "
                    f"not {acc_dtype}")
  if not x.is_contiguous():
    raise ValueError("fused_sum kernel needs a contiguous x")
  dev_vals = [scalars[k] for k in program.dev_scalars]
  for v in dev_vals:
    if v.device != x.device or v.numel() != 1:
      raise ValueError(f"device scalar {tuple(v.shape)} on {v.device} does "
                       f"not fit x on {x.device}")
  lib = _library()
  n = x.numel()
  sms = torch.cuda.get_device_properties(x.device).multi_processor_count
  room = max(1, min(-(-n // (THREADS * 8)), sms * PARTIALS_PER_SM))
  partials = torch.empty(room, dtype=acc_dtype, device=x.device)
  out = torch.empty((), dtype=acc_dtype, device=x.device)
  dscal = (torch.stack([v.reshape(()).to(torch.float64) for v in dev_vals])
           if dev_vals else None)
  prog = program.host_struct(scalars)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.spartan_fused_sum(
        x.data_ptr(), _IN_CODES[x.dtype], n, ctypes.addressof(prog),
        dscal.data_ptr() if dscal is not None else None,
        partials.data_ptr(), room, out.data_ptr(), _ACC_CODES[acc_dtype],
        stream)
  if rc != 0:
    raise RuntimeError("fused_sum kernel launch failed: "
                       + lib.spartan_cuda_error_string(rc).decode())
  counts["launches"] += 1
  return out
